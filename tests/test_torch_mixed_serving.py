"""Port parity for serving the archs whose layers keep per-slot state beside
the page pool: recurrentgemma-2b (RG-LRU + sliding-window rings, no paged
layer at all), mamba2-370m (Mamba-2 SSD only) and gemma3-27b (window rings
beside paged global layers), on the CPU in f32.

Against the JAX engines: the static ``Engine`` and every ``ContinuousEngine``
mode (paged chunked, batched, scatter; ``paged=False``), prefix sharing on
and off, and an int8 KV cache (recurrentgemma's rings): identical greedy
tokens and preemptions.  Then the engine cases of ``tests/test_chunked.py``
and ``tests/test_prefix.py:211`` (a ring-size chunk starting mid-ring, LRU
resume, slot reuse resetting rings and recurrent states, the batched tick
with prefix sharing on and off, forks copying the rings, preemption)
against the port's own oracles (the scatter mode, an unshared engine, a
generous pool), as those tests hold the JAX engine against its own;
speculative decoding with each arch as target and as drafter (against a
plain llama3 partner) against the non-speculative engine, the refusal of an
encoder-decoder config by the continuous engine and the CLI, and the CLI.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import model as jm
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Engine as JaxStatic
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

PRE = [7, 7, 3, 5, 1, 2, 9, 4]  # 2 full pages at page_size=4: a shared preamble
# prompts past the reduced window (8), one of exactly a window, and the
# preamble again while its first holder still decodes; chunks of 8 and 5
PROMPTS = [PRE + list(range(11, 19)), list(range(1, 9)), PRE + [13, 14, 15, 16, 17],
           list(range(1, 25)), PRE + list(range(21, 29))]
NEW = [10, 6, 6, 6, 6]
PAGED = dict(slots=2, capacity=40, paged=True, page_size=4, n_pages=20, prefill_chunk=8)


@functools.lru_cache(maxsize=None)
def load(name):
    jcfg = jax_make_reduced(jax_get_config(name))
    tcfg = make_reduced(get_config(name))
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def own(name):
    """A reduced arch with the port's own seed-0 weights (the port-only cases)."""
    cfg = make_reduced(get_config(name))
    return cfg, tm.init_params(cfg, seed=0, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_tokens(name, kind, kv_bits):
    jcfg, _, jparams, _ = load(name)
    if kind == "static":
        eng = JaxStatic(jcfg, jparams, JaxEngineConfig(max_batch=5, max_prefill=24, max_decode=10,
                                                       kv_cache_bits=kv_bits))
        return [r.tokens for r in eng.generate([JaxRequest(p, n) for p, n in zip(PROMPTS, NEW)])]
    eng = JaxEngine(jcfg, jparams, kv_cache_bits=kv_bits, prefix_sharing=True, **PAGED)
    ids = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n)) for p, n in zip(PROMPTS, NEW)]
    done = eng.run_until_done()
    return [done[i].tokens for i in ids], eng.preemptions


def serve(cfg, params, prompts, news, **kw):
    eng = ContinuousEngine(cfg, params, device="cpu", **kw)
    ids = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    done = eng.run_until_done()
    if eng.paged:
        assert eng.pool.free_count == eng.n_pages
        eng.pool.check()
    return [done[i].tokens for i in ids], eng


# ---------------------------------------------------------------------------
# Against the JAX engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kv_bits", [("recurrentgemma-2b", 0), ("recurrentgemma-2b", 8),
                                          ("mamba2-370m", 0)])
def test_static_engine_matches_jax(name, kv_bits):
    _, tcfg, _, tparams = load(name)
    eng = Engine(tcfg, tparams, EngineConfig(max_batch=5, max_prefill=24, max_decode=10,
                                             kv_cache_bits=kv_bits), device="cpu")
    got = eng.generate([Request(p, n) for p, n in zip(PROMPTS, NEW)])
    assert [r.tokens for r in got] == jax_tokens(name, "static", kv_bits)


@pytest.mark.parametrize("name,kv_bits", [("recurrentgemma-2b", 0), ("recurrentgemma-2b", 8),
                                          ("mamba2-370m", 0)])
@pytest.mark.parametrize("mode,prefix", [("chunked", False), ("chunked", True), ("batched", False),
                                         ("batched", True), ("scatter", True), ("contiguous", False)])
def test_continuous_engine_matches_jax(name, kv_bits, mode, prefix):
    """Every mode against the JAX paged engine's tokens and preemptions (its
    modes agree with one another, ``tests/test_chunked.py``); under sharing
    the prefix is recomputed, since no layer's state is in the pool."""
    _, tcfg, _, tparams = load(name)
    if mode == "contiguous":
        kw = dict(slots=2, capacity=40, kv_cache_bits=kv_bits)
    else:
        kw = dict(PAGED, prefill_mode=mode, prefix_sharing=prefix, kv_cache_bits=kv_bits)
    toks, eng = serve(tcfg, tparams, PROMPTS, NEW, **kw)
    assert (toks, eng.preemptions) == jax_tokens(name, "paged", kv_bits)
    if prefix:
        assert eng.prefix_hits >= 1 and eng.prefill_tokens_skipped == 0


# ---------------------------------------------------------------------------
# The engine cases of test_chunked.py and test_prefix.py
# ---------------------------------------------------------------------------


def test_ring_size_chunk_starting_mid_ring():
    """gemma3: a chunk of exactly ring size at a position that is not a ring
    multiple (prompt 20, chunk 12: the last chunk [12, 20) lands at offset
    4 of the ring of 8) writes at ``pos % cap``; the same tokens as the
    scatter oracle."""
    cfg, params = own("gemma3-27b")
    prompt = [(5 * i) % 89 + 1 for i in range(20)]
    kw = dict(slots=1, capacity=32, paged=True, page_size=4, n_pages=8)
    want, _ = serve(cfg, params, [prompt], [8], prefill_mode="scatter", **kw)
    got, _ = serve(cfg, params, [prompt], [8], prefill_mode="chunked", prefill_chunk=12, **kw)
    assert got == want


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "mamba2-370m"])
def test_recurrent_resume_across_chunks(name):
    """LRU / SSD state and conv prefix resumed across chunks of 4: the
    scatter oracle's tokens."""
    cfg, params = own(name)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13]]
    kw = dict(slots=2, capacity=24, paged=True, page_size=4, n_pages=12)
    want, _ = serve(cfg, params, prompts, [5, 5], prefill_mode="scatter", **kw)
    got, _ = serve(cfg, params, prompts, [5, 5], prefill_mode="chunked", prefill_chunk=4, **kw)
    assert got == want


@pytest.mark.parametrize("name,prompts", [
    ("recurrentgemma-2b", ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13])),
    ("mamba2-370m", ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13])),
    # the second occupant is shorter than the window: stale ring entries
    # would survive the causal mask if the first chunk resumed
    ("gemma3-27b", ([21, 22, 23, 24, 25, 26, 27, 28, 29, 30], [31, 32, 33])),
])
@pytest.mark.parametrize("mode", ["chunked", "batched"])
def test_slot_reuse_resets_per_slot_state(name, prompts, mode):
    """Back-to-back requests through one slot: the first chunk of each
    admission starts the slot's rings and states fresh, so each gets the
    tokens of a fresh engine."""
    cfg, params = own(name)
    kw = dict(slots=1, capacity=24, paged=True, page_size=4, n_pages=12)
    eng = ContinuousEngine(cfg, params, device="cpu", prefill_chunk=4, prefill_mode=mode, **kw)
    outs = []
    for p in prompts:
        rid = eng.submit(Request(prompt=p, max_new_tokens=5))
        outs.append(eng.run_until_done()[rid].tokens)
    for p, got in zip(prompts, outs):
        want, _ = serve(cfg, params, [p], [5], prefill_mode="scatter", **kw)
        assert got == want[0], (p, got, want[0])


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("name", ["gemma3-27b", "recurrentgemma-2b", "mamba2-370m"])
def test_batched_tick_matches_chunked(name, prefix):
    """5 prompts onto 4 slots, several mid-prefill in one batched call (rows
    of different lengths, padding inert), prefix sharing on and off: the
    chunked engine's tokens."""
    cfg, params = own(name)
    rng = np.random.RandomState(0)
    prompts = [PRE + [int(t) for t in rng.randint(1, 97, size=n)] for n in (13, 1)] + \
        [[9, 8, 7], [1, 2]] + [PRE + [int(t) for t in rng.randint(1, 97, size=5)]]
    kw = dict(slots=4, capacity=32, paged=True, page_size=4, prefill_chunk=8, prefix_sharing=prefix)
    news = [6] * len(prompts)
    want, _ = serve(cfg, params, prompts, news, prefill_mode="chunked", **kw)
    got, eng = serve(cfg, params, prompts, news, prefill_mode="batched", **kw)
    assert got == want
    if prefix:
        assert eng.prefix_hits >= 1 and eng.prefill_tokens_skipped == 0
    assert any(m.get("batched_prefill_occupancy", 0) > 0.25 for m in eng.metrics_log)


@pytest.mark.parametrize("name", ["gemma3-27b", "recurrentgemma-2b"])
def test_window_ring_mix_under_sharing(name):
    """``test_prefix.py:211``: sharing gives the unshared tokens, and
    ``submit_n`` forks (sharing every page of their base) copy its rings and
    states row-wise, so they draw the tokens of independent requests."""
    cfg, params = own(name)
    prompts = [PRE + [11, 12], PRE + [13], [1, 2, 3]]
    kw = dict(slots=2, capacity=24, paged=True, page_size=4, n_pages=12)
    want, _ = serve(cfg, params, prompts, [6] * 3, **kw)
    got, eng = serve(cfg, params, prompts, [6] * 3, prefix_sharing=True, **kw)
    assert got == want and eng.prefix_hits >= 1
    req = Request(prompt=PRE + [41, 42], max_new_tokens=5)
    oracle = ContinuousEngine(cfg, params, device="cpu", **kw)
    rids_o = oracle.submit_n(req, 2)
    done_o = oracle.run_until_done()
    eng2 = ContinuousEngine(cfg, params, device="cpu", prefix_sharing=True, **kw)
    rids = eng2.submit_n(req, 2)
    assert eng2.pool.refcount(int(eng2.tables.row(0)[0])) == 2  # the fork shares the base's pages
    done = eng2.run_until_done()
    assert [done[r].tokens for r in rids] == [done_o[r].tokens for r in rids_o]
    assert eng2.pool.free_count == eng2.n_pages


@pytest.mark.parametrize("name", ["gemma3-27b", "recurrentgemma-2b", "mamba2-370m"])
def test_preemption_resumes_exactly(name):
    """A pool too small for every slot's growth preempts; the preempted
    request resumes by re-prefilling into fresh per-slot state and gives the
    tokens of a generous pool."""
    cfg, params = own(name)
    prompts = [list(range(1, 14)), list(range(20, 31)), list(range(40, 49))]
    kw = dict(slots=3, capacity=32, paged=True, page_size=4, prefill_chunk=8)
    want, _ = serve(cfg, params, prompts, [12] * 3, n_pages=30, **kw)
    got, eng = serve(cfg, params, prompts, [12] * 3, n_pages=10, **kw)
    assert eng.preemptions >= 1
    assert got == want


# ---------------------------------------------------------------------------
# Refusals and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma3-27b", "recurrentgemma-2b", "mamba2-370m"])
@pytest.mark.parametrize("role", ["target", "drafter"])
def test_spec_draft_with_per_slot_state(name, role):
    """Speculative decoding with the arch as the target (a plain llama3
    drafter) or as the drafter (for a llama3 target) on this file's trace:
    the non-speculative engine's greedy tokens; the commit pass advances a
    target's per-slot leaves, a drafter with per-slot state resyncs after a
    partial accept."""
    arch, plain = own(name), own("llama3-8b")
    target, drafter = (arch, plain) if role == "target" else (plain, arch)
    base, _ = serve(*target, PROMPTS, NEW, **PAGED)
    spec, eng = serve(*target, PROMPTS, NEW, spec_draft=drafter, spec_k=3, **PAGED)
    assert spec == base
    sp = [m["spec"] for m in eng.metrics_log if "spec" in m]
    if role == "drafter" and any(s["accepted"] < s["drafted"] for s in sp):
        assert eng.spec_resyncs > 0


@pytest.mark.parametrize("name", ["gemma3-27b", "recurrentgemma-2b", "mamba2-370m"])
@pytest.mark.parametrize("flags", [[], ["--paged", "--page-size", "4", "--pages", "12", "--slots", "2",
                                        "--prefill-chunk", "8", "--prefix-sharing"]],
                         ids=["static", "paged"])
def test_cli_serves_on_cpu(capsys, name, flags):
    tserve.main(["--arch", name, "--reduced", "--device", "cpu", "--requests", "3",
                 "--prompt-len", "10", "--new-tokens", "4", "--kv-bits", "8", *flags])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "device=cpu" in out
    if flags:
        assert "free pages 12/12" in out


def test_cli_spec_draft_self_serves_gemma3(capsys):
    tserve.main(["--arch", "gemma3-27b", "--reduced", "--device", "cpu", "--paged",
                 "--page-size", "4", "--spec-draft", "self", "--spec-k", "3", "--requests", "3",
                 "--prompt-len", "10", "--new-tokens", "5"])
    out = capsys.readouterr().out
    # each request's first token is its prefill's, the other 4 speculative
    assert "served 3 requests, 15 tokens" in out and "speculation: 12 tokens / " in out
    assert "accept rate 1.00" in out and "0 drafter resyncs" in out


def test_continuous_engine_refuses_encoder_decoder():
    cfg, params = own("seamless-m4t-medium")
    for kw in (PAGED, dict(slots=2, capacity=40)):
        with pytest.raises(ValueError, match="encoder-decoder.*memory"):
            ContinuousEngine(cfg, params, device="cpu", **kw)


@pytest.mark.parametrize("flags", [[], ["--paged"]], ids=["static", "paged"])
def test_cli_refuses_encoder_decoder(capsys, flags):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu", *flags])
    assert "encoder-decoder" in capsys.readouterr().err


@pytest.mark.parametrize("name,kv_bits", [("gemma3-27b", 8), ("recurrentgemma-2b", 8),
                                          ("mamba2-370m", 0)])
def test_chunked_prefill_and_decode_logits_match_jax(name, kv_bits):
    """The model level of the paged path: a 12-token prompt through three
    chunks into slot 1 of 2 (the first resetting the slot's rings and
    states), then a decode step with slot 0 inactive: every logit within
    1e-4 of JAX's (f32; int8 K/V within 2e-3, where a last-bit difference
    can move one quantized value)."""
    jcfg, tcfg, jparams, tparams = load(name)
    cap, ps, n_pages, slot = 24, 4, 10, 1
    prompt = [3, 5, 7, 9, 11, 2, 4, 6, 8, 1, 13, 12]
    tol = dict(atol=2e-3 if kv_bits else 1e-4, rtol=1e-4)
    table = np.full((2, cap // ps), -1, np.int32)
    table[slot, :3] = [7, 2, 5]  # pages out of order
    jc = jm.init_paged_caches(jcfg, 2, cap, n_pages=n_pages, page_size=ps, kv_bits=kv_bits)
    tc = tm.init_paged_caches(tcfg, 2, cap, n_pages=n_pages, page_size=ps, kv_bits=kv_bits,
                              device="cpu")
    jchunk = jax.jit(lambda p, t, pos, c, row, reset: jm.paged_prefill_chunk(
        jcfg, p, t, pos, jnp.int32(slot), c, row, capacity=cap, kv_bits=kv_bits, page_size=ps,
        reset=reset), static_argnums=5)
    for j, (s, e) in enumerate([(0, 4), (4, 8), (8, 12)]):
        toks = np.asarray([prompt[s:e]], np.int32)
        pos = np.arange(s, e, dtype=np.int32)[None]
        jl, jc = jchunk(jparams, toks, pos, jc, jnp.asarray(table[slot]), j == 0)
        tl, tc = tm.paged_prefill_chunk(tcfg, tparams, torch.from_numpy(toks).long(),
                                        torch.from_numpy(pos), tc, torch.from_numpy(table[slot]),
                                        slot=slot, reset=j == 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    table[slot, 3] = 9
    tok = np.asarray([[0], [int(np.argmax(np.asarray(jl)))]], np.int32)
    posd = np.asarray([0, len(prompt)], np.int32)
    active = np.asarray([False, True])
    jl, _ = jax.jit(lambda p, t, pos, a, c, tb: jm.paged_ragged_decode_step(jcfg, p, t, pos, a, c, tb))(
        jparams, tok, posd, active, jc, table)
    tl, _ = tm.paged_ragged_decode_step(tcfg, tparams, torch.from_numpy(tok).long(),
                                        torch.from_numpy(posd), tc, torch.from_numpy(table),
                                        active=torch.from_numpy(active))
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1], **tol)
