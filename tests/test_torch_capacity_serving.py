"""Port parity for capacity-dispatch serving beyond each config's default:
the one-hot ``einsum`` dispatch, a capacity factor small enough that the
prefill drops assignments, int8 experts (kernel 3's plain version) under
``dense``, the paged ``ContinuousEngine`` under reduced llama4-maverick's own
``moe_impl``, and the launcher, against the JAX package in f32 on the CPU.

Greedy tokens, preemption counts and the drained pool must be identical.
Under the continuous engine every decode row, inactive and mid-prefill
slots included, and every token of a chunk competes for capacity.  An
inactive row's attention sees no valid key: the paged kernels, the JAX
package's and the port's, give it 0, while the JAX package's CPU oracle
path gives it a uniform average (ROADMAP.md queue 3), so its MoE input
differs there.  With 3 slots (capacity 8 per expert) no decode step can
drop; the 12-slot case with a skewed router drops at decode, with inactive
rows in the batch, and is held against the JAX engine on its kernel path
(the Pallas kernels in interpret mode), which is what it runs on the TPU.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.registry import with_capacity_factor as jax_with_capacity_factor
from repro.core.gating import RoutingStats
from repro.models import attention as jattention
from repro.models import model as jm
from repro.quant import quantize_params as jquantize_params
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import with_capacity_factor
from repro_torch.core import moe as tmoe
from repro_torch.launch import serve as tserve
from repro_torch.quant import quantize_params
from repro_torch.serving import continuous as tcontinuous
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Request
from test_torch_capacity_engine import greedy, load
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ARCH = "llama4-maverick-400b-a17b"


def prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, n).tolist() for n in lens]


@pytest.fixture(scope="module")
def llama4():
    return load(ARCH)


def test_einsum_dispatch_greedy_tokens_identical(llama4):
    jcfg, tcfg, jparams, tparams = llama4
    jt, tt = greedy(jcfg.replace(moe_impl="einsum"), tcfg.replace(moe_impl="einsum"), jparams,
                    tparams, prompts((5, 9, 3)))
    assert tt == jt and all(len(r) == 8 for r in tt)


def test_capacity_drops_greedy_tokens_identical(llama4):
    """Capacity factor 0.25: the prefill's 27 rows share 8 slots per expert,
    and JAX's own routing statistics show that it drops."""
    jcfg, tcfg, jparams, tparams = llama4
    jcfg, tcfg = jax_with_capacity_factor(jcfg, 0.25), with_capacity_factor(tcfg, 0.25)
    ps = prompts((5, 9, 3), seed=2)
    toks = np.zeros((3, 9), np.int32)  # the engine's right-aligned, 0-padded prefill batch
    for i, p in enumerate(ps):
        toks[i, 9 - len(p):] = p
    _, _, routing = jax.jit(lambda p, t: jm.forward(jcfg, p, t, return_routing=True))(
        jparams, jax.numpy.asarray(toks))
    stats = jax.tree.leaves(routing, is_leaf=lambda n: isinstance(n, RoutingStats))
    dropped = [float(np.max(s.dropped_frac)) for s in stats if isinstance(s, RoutingStats)]
    assert dropped and max(dropped) > 0, dropped
    jt, tt = greedy(jcfg, tcfg, jparams, tparams, ps)
    assert tt == jt


def test_int8_experts_dense_greedy_tokens_identical(llama4):
    """int8 experts under the config's own dispatch: kernel 3's plain
    version on the port's side, ``expert_mlp_quant_ref`` on JAX's."""
    jcfg, tcfg, jparams, tparams = llama4
    jqp = jquantize_params(jparams, JQuantConfig(bits=8))
    tqp = quantize_params(tparams, QuantConfig(bits=8))
    jt, tt = greedy(jcfg, tcfg, jqp, tqp, prompts((5, 9, 3), seed=3))
    assert tt == jt


def test_continuous_engine_traffic(llama4):
    """Five prompts through 3 slots and a 10-page pool: admission waits for
    pages, decode growth preempts, and the pool drains."""
    jcfg, tcfg, jparams, tparams = llama4
    kw = dict(slots=3, capacity=32, paged=True, page_size=4, prefill_chunk=6, n_pages=10)
    ps = prompts((13, 6, 9, 3, 17), seed=4)

    def run(eng, req):
        ids = [eng.submit(req(prompt=p, max_new_tokens=7)) for p in ps]
        done = eng.run_until_done()
        return [done[i].tokens for i in ids], eng.preemptions, eng.pool.free_count

    jres = run(JaxEngine(jcfg, jparams, **kw), JaxRequest)
    tres = run(ContinuousEngine(tcfg, tparams, device="cpu", **kw), Request)
    assert tres == jres
    assert tres[1] >= 1 and tres[2] == 10


def test_continuous_engine_drops_at_decode_as_the_jax_kernel_path(llama4, monkeypatch):
    """12 slots, more than one expert's capacity of 8, and a router skewed
    toward expert 0 (a shared direction added to every embedding and to the
    router's column 0).  Request i decodes 2 + 2i tokens, so the finished
    slots, whose rows come first in token-major order, sit idle beside the
    live ones; decode steps drop assignments with idle rows in the batch,
    and the port's tokens match the JAX engine's on its kernel path.  (On
    this trace the JAX engine's CPU oracle path, whose idle rows see a
    uniform average, emits other tokens for one request.)"""
    jcfg, tcfg, jparams, _ = llama4
    tree = jax.tree.map(np.array, jparams)
    v = np.random.default_rng(7).standard_normal(jcfg.d_model).astype(np.float32)
    v /= np.linalg.norm(v)
    tree["embed"] += 0.5 * v
    tree["segments"]["seg0"]["pos1"]["moe"]["router"][..., 0] += 0.05 * v
    tparams = convert.params_from_numpy(tcfg, tree, "cpu")
    slots = 12
    kw = dict(slots=slots, capacity=48, paged=True, page_size=4, prefill_chunk=6,
              n_pages=12 * slots + 2)
    ps = prompts((5, 3, 9, 4, 7, 2, 6, 8, 3, 5, 4, 6), seed=7)

    def run(eng, req):
        ids = [eng.submit(req(prompt=p, max_new_tokens=2 + 2 * i)) for i, p in enumerate(ps)]
        done = eng.run_until_done()
        return [done[i].tokens for i in ids], eng.preemptions, eng.pool.free_count

    steps = []  # per decode step: [inactive rows, dropped assignments]
    step, gate = tcontinuous.paged_ragged_decode_step, tmoe.gating

    def record_step(cfg, params, token, positions, caches, table, **kw):
        steps.append([int((table < 0).all(1).sum()), 0])
        return step(cfg, params, token, positions, caches, table, **kw)

    def record_gating(logits, top_k, capacity, **kw):
        g, counts = gate(logits, top_k, capacity, **kw)
        if logits.shape[0] == slots:
            steps[-1][1] += int((~g.keep).sum())
        return g, counts

    monkeypatch.setattr(tcontinuous, "paged_ragged_decode_step", record_step)
    monkeypatch.setattr(tmoe, "gating", record_gating)
    tres = run(ContinuousEngine(tcfg, tparams, device="cpu", **kw), Request)
    assert any(idle and dropped for idle, dropped in steps), steps
    jattention.set_paged_backend("kernel")
    try:
        jres = run(JaxEngine(jcfg, jax.tree.map(jax.numpy.asarray, tree), **kw), JaxRequest)
    finally:
        jattention.set_paged_backend(None)
    assert tres == jres
    assert tres[2] == kw["n_pages"]


@pytest.mark.parametrize("argv,arch_impl", [
    (["--arch", ARCH], "moe_impl=ep"),
    (["--arch", ARCH, "--moe-impl", "einsum"], "moe_impl=einsum"),
    (["--arch", "nlg-350m-moe128"], "moe_impl=dense"),
    (["--arch", ARCH, "--paged", "--page-size", "4", "--pages", "8", "--slots", "2",
      "--prefill-chunk", "8"], "moe_impl=ep, paged"),
])
def test_cli_serves_the_arch_own_dispatch(capsys, argv, arch_impl):
    tserve.main([*argv, "--reduced", "--device", "cpu", "--requests", "3", "--batch", "2",
                 "--prompt-len", "6", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and arch_impl in out and "device=cpu" in out


def test_cli_grouped_on_a_dense_arch_is_an_error(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "llama3-8b", "--reduced", "--device", "cpu", "--moe-impl", "grouped"])
    assert "has no MoE layers to dispatch" in capsys.readouterr().err
