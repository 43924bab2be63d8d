"""Port parity for continuous batching over a paged KV pool: the JAX
``ContinuousEngine(paged=True, prefill_mode="chunked")`` and the port's, on
reduced llama4-maverick and kimi-k2 with ``moe_impl="grouped"`` (dropless,
so inactive and mid-prefill rows cannot change another row's routing), in
f32 on the CPU, driven through the same request traces and scheduler
actions.

Greedy tokens per request id must be identical, and so must the preemption
count; the pool must drain.  The engines share no state: weights are handed
over as numpy arrays.  (Sampled tokens are not compared: the port draws from
a ``torch.Generator``.)
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import model as jm
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.launch import serve as tserve
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Request
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ARCHS = ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"]
# page size 4, chunk budget 6: every chunk but the last ends on a page
# boundary and leaves 2 tokens of budget that wait for the next tick
PAGED = dict(capacity=32, paged=True, page_size=4, prefill_chunk=6)


@functools.lru_cache(maxsize=None)
def load(name):
    jcfg = jax_make_reduced(jax_get_config(name)).replace(moe_impl="grouped")
    tcfg = make_reduced(get_config(name)).replace(moe_impl="grouped")
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return load(request.param)


@pytest.fixture(scope="module")
def llama4():
    return load(ARCHS[0])


def both(pair, script, **kw):
    """Run ``script(engine, Request)`` on a JAX and a port engine built with
    the same options; returns the two results."""
    jcfg, tcfg, jparams, tparams = pair
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    return script(jeng, JaxRequest), script(teng, Request), teng


def serve(prompts, n_new):
    def script(eng, req):
        ids = [eng.submit(req(prompt=p, max_new_tokens=n_new)) for p in prompts]
        done = eng.run_until_done()
        return [done[i].tokens for i in ids], eng.preemptions
    return script


def prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, n).tolist() for n in lens]


def test_traffic_with_preemption(pair):
    """Five prompts, none page-aligned, through 3 slots and a 10-page pool
    (a third of the slots' worst case): admission waits for pages, decode
    growth runs the pool dry and preempts the youngest slot, which resumes
    by re-prefilling prompt + generated tokens."""
    (jt, jp), (tt, tp), eng = both(pair, serve(prompts((13, 6, 9, 3, 17)), 7), slots=3, n_pages=10,
                                   **PAGED)
    assert tt == jt
    assert tp == jp >= 1
    assert eng.pool.free_count == eng.n_pages and not eng.queue
    assert all(len(t) == 7 for t in tt)


def test_midprefill_preemption_resumes_exactly(llama4):
    """A slot preempted while still prefilling frees its pages; its
    re-admission restarts the chunked prefill and ends token-exact."""
    p = prompts((14,), 1)[0]

    def script(eng, req):
        rid = eng.submit(req(prompt=p, max_new_tokens=6))
        assert eng.slots[0].prefilling and eng.slots[0].prefill_done == 4
        eng._preempt(0)
        assert eng.pool.free_count == eng.n_pages
        return eng.run_until_done()[rid].tokens, eng.preemptions

    (jt, jp), (tt, tp), _ = both(llama4, script, slots=1, n_pages=8,
                                 **dict(PAGED, prefill_chunk=4))
    assert (tt, tp) == (jt, jp) == (serve([p], 6)(ContinuousEngine(
        llama4[1], llama4[3], device="cpu", slots=1, n_pages=8, **PAGED), Request)[0][0], 1)


def test_double_preemption_resumes_exactly(llama4):
    """Preempting one request twice mid-decode must not duplicate its
    generated prefix in the rebuilt context."""
    p = prompts((6,), 2)[0]

    def script(eng, req):
        rid = eng.submit(req(prompt=p, max_new_tokens=10))
        eng.step(); eng.step()
        eng._preempt(0)
        eng.step(); eng.step()
        eng._preempt(0)
        return eng.run_until_done()[rid].tokens, eng.preemptions

    (jt, jp), (tt, tp), eng = both(llama4, script, slots=1, **PAGED)
    alone = serve([p], 10)(ContinuousEngine(llama4[1], llama4[3], device="cpu", slots=1, **PAGED),
                           Request)[0][0]
    assert (tt, tp) == (jt, jp) == (alone, 2)
    assert eng.pool.free_count == eng.n_pages


def test_page_reuse_is_clean(llama4):
    """Back-to-back requests through one engine reuse the first request's
    pages; their positions were reset, so each request equals itself served
    by a fresh engine."""
    ps = prompts((7, 5), 3)

    def script(eng, req):
        out = []
        for p in ps:
            rid = eng.submit(req(prompt=p, max_new_tokens=6))
            out.append(eng.run_until_done()[rid].tokens)
        return out

    jt, tt, _ = both(llama4, script, slots=1, n_pages=8, **PAGED)
    fresh = [serve([p], 6)(ContinuousEngine(llama4[1], llama4[3], device="cpu", slots=1, n_pages=8,
                                            **PAGED), Request)[0][0] for p in ps]
    assert tt == jt == fresh


def test_admission_by_free_block_count(llama4):
    """Two free slots are not enough: a 12-token prompt takes 3 of the 4
    pool pages, so the second request waits in the queue."""
    ps = prompts((12, 12), 4)

    def script(eng, req):
        ids = [eng.submit(req(prompt=p, max_new_tokens=4)) for p in ps]
        state = (sum(s.active for s in eng.slots), len(eng.queue))
        done = eng.run_until_done()
        return state, [done[i].tokens for i in ids]

    jt, tt, eng = both(llama4, script, slots=2, n_pages=4, **dict(PAGED, capacity=16))
    assert tt == jt
    assert tt[0] == (1, 1)
    assert eng.pool.free_count == 4


def test_prompt_truncated_to_capacity(llama4):
    """max_new_tokens >= capacity clamps the budget to capacity - 1 and keeps
    the LAST context token: the same tokens as that token alone."""
    p = prompts((12,), 5)[0]
    kw = dict(PAGED, capacity=8)
    jt, tt, _ = both(llama4, serve([p], 20), slots=1, **kw)
    alone = serve([p[-1:]], 7)(ContinuousEngine(llama4[1], llama4[3], device="cpu", slots=1, **kw),
                               Request)
    assert tt == jt == alone
    assert len(tt[0][0]) == 7


# options the engine refuses where their requirement is missing: an
# expert-parallel mesh needs one process per rank in a default process
# group (serving/ep.py's launch; served in test_torch_ep_serving.py)
UNPORTED = [
    ("ep_mesh", dict(ep_mesh=(2,)), RuntimeError, "process group"),
]


@pytest.mark.parametrize("opt,exc,match", [(o, e, m) for _, o, e, m in UNPORTED],
                         ids=[n for n, _, _, _ in UNPORTED])
def test_unported_options_raise(llama4, opt, exc, match):
    _, tcfg, _, tparams = llama4
    opt = dict(opt)
    with pytest.raises(exc, match=match):
        cfg = tcfg.replace(ep_mesh=opt.pop("ep_mesh")) if "ep_mesh" in opt else tcfg
        ContinuousEngine(cfg, tparams, device="cpu", **{**PAGED, **opt})


def test_cli_paged_on_cpu(capsys):
    tserve.main(["--arch", ARCHS[0], "--reduced", "--moe-impl", "grouped", "--device", "cpu",
                 "--paged", "--page-size", "4", "--pages", "8", "--slots", "2",
                 "--prefill-chunk", "8", "--requests", "3", "--prompt-len", "6",
                 "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "paged" in out and "device=cpu" in out
    assert "free pages 8/8" in out


@pytest.mark.parametrize("flags,extra", [
    (["--prefix-sharing"], "prefix sharing: "),
    (["--n-samples", "2"], "served 6 requests, 24 tokens"),
    (["--prefill-mode", "batched"], "prefill_mode=batched"),
    (["--prefill-mode", "scatter"], "prefill_mode=scatter"),
    (["--prefix-sharing", "--n-samples", "2", "--prefill-mode", "batched"], "prefix sharing: "),
], ids=["prefix-sharing", "n-samples", "batched", "scatter", "all-three"])
def test_cli_paged_modes_on_cpu(capsys, flags, extra):
    """The paged engine's prefill modes, prefix sharing and parallel samples
    from the command line, on the CPU; the pool drains."""
    tserve.main(["--arch", ARCHS[0], "--reduced", "--moe-impl", "grouped", "--device", "cpu",
                 "--paged", "--page-size", "4", "--pages", "12", "--slots", "3",
                 "--prefill-chunk", "8", "--requests", "3", "--prompt-len", "6",
                 "--new-tokens", "4", *flags])
    out = capsys.readouterr().out
    assert extra in out and "free pages 12/12" in out


@pytest.mark.parametrize("flags,err", [
    (["--slots", "2"], "pass --paged"),
    (["--prefix-sharing"], "--prefix-sharing requires --paged"),
    (["--prefill-mode", "batched"], "pass --paged"),
    (["--n-samples", "2"], "pass --paged"),
    (["--paged", "--n-samples", "0"], "--n-samples must be >= 1"),
    (["--spec-draft", "self"], "pass --paged"),
])
def test_cli_rejects_unported_paged_flags(capsys, flags, err):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCHS[0], "--reduced", "--device", "cpu", *flags])
    assert err in capsys.readouterr().err
