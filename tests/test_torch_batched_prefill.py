"""Port parity for the batched prefill tick and the scatter oracle: the
batched kernel 8 / 8q's plain version against JAX's
``_paged_prefill_chunk_attend_batched`` (its Pallas kernel path in
interpret mode, and its einsum path on the rows with a valid query), the
model entries ``paged_prefill_chunk_batched`` and ``paged_prefill_into_slot``
against JAX's, and the engine with ``prefill_mode="batched"`` and
``"scatter"`` against the JAX engine (the cases of ``tests/test_chunked.py``
``TestBatchedPrefillTick`` and ``TestEngineParity``), on reduced glm4-9b and,
under its own capacity dispatch, reduced llama4-maverick, in f32 on the CPU.

Tolerances: attention outputs, logits and written K/V agree to 1e-5 (f32,
the same products summed in another order); positions, tables and engine
records are exact (``test_torch_prefix.record``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnSpec
from repro.models import attention as jattn
from repro.models import model as jm
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.core import moe as tmoe
from repro_torch.kernels import attention_prefill_paged as tk8
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Request
from test_torch_prefix import PRE, both, copy_into, leaves_like, load, record, serve
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-5)
PAGED = dict(capacity=32, paged=True, page_size=4)


@pytest.fixture(scope="module")
def glm4():
    return load("glm4-9b")


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# The batched kernel 8's plain version
# ---------------------------------------------------------------------------


def batched_inputs(kv_bits, seed=0):
    """Four rows of 12-query chunks over one pool of 40 pages of 4: histories
    of 9 and 17 tokens, an empty one, and an inactive row; row 2 has 5 real
    queries and padding.  JAX's layout: q [B, C, H, dh], k/v [B, C, Hkv,
    dh], an int8 pool as ``QuantizedKV``."""
    from repro.quant.kv import QuantizedKV

    B, C, Hkv, G, dh, ps, Pt, nt = 4, 12, 2, 3, 32, 4, 40, 10
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    kpos = np.full((Pt, ps), -1, np.int32)
    tables = np.full((B, nt), -1, np.int32)
    positions = np.full((B, C), -1, np.int32)
    perm, used = rng.permutation(Pt - 1), 0
    for b, (n, nq) in enumerate([(9, 12), (None, 0), (0, 5), (17, 12)]):
        if n is None:
            continue
        pages = perm[used:used + -(-(n + nq) // ps)]
        used += len(pages)
        tables[b, :len(pages)] = pages
        kpos[pages[np.arange(n) // ps], np.arange(n) % ps] = np.arange(n)
        positions[b, :nq] = np.arange(n, n + nq)
    cache = {"k": jnp.asarray(f(Pt, ps, Hkv, dh)), "v": jnp.asarray(f(Pt, ps, Hkv, dh)),
             "pos": jnp.asarray(kpos)}
    if kv_bits:
        cache["k"], cache["v"] = QuantizedKV.quantize(cache["k"]), QuantizedKV.quantize(cache["v"])
    return (jnp.asarray(f(B, C, Hkv * G, dh)), jnp.asarray(f(B, C, Hkv, dh)),
            jnp.asarray(f(B, C, Hkv, dh)), cache, jnp.asarray(positions), jnp.asarray(tables))


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_batched_kernel_plain_matches_jax(kv_bits):
    """Every row against JAX's Pallas path (padded queries and the inactive
    row exactly 0 on both sides), and the rows with a valid query against
    its einsum path; also each row against the single-row plain version."""
    q, k, v, cache, positions, tables = batched_inputs(kv_bits)
    spec, scale = AttnSpec(kind="global"), 0.2
    B, C, H, dh = q.shape
    Hkv = k.shape[2]
    out = {}
    for mode in ("kernel", "ref"):
        jattn.set_paged_backend(mode)
        try:
            out[mode] = np.asarray(jattn._paged_prefill_chunk_attend_batched(
                q, k, v, cache, positions, tables, spec, scale))
        finally:
            jattn.set_paged_backend(None)
    if kv_bits:
        pool = dict(k_scale=t(cache["k"].scale), v_scale=t(cache["v"].scale))
        pk, pv = t(cache["k"].q), t(cache["v"].q)
    else:
        pool, pk, pv = {}, t(cache["k"]), t(cache["v"])
    Pt = cache["pos"].shape[0]
    tbl = torch.where(t(tables) < 0, Pt - 1, t(tables)).int()
    args = (t(q).view(B, C, Hkv, H // Hkv, dh), pk, pv, t(cache["pos"]), tbl, t(positions),
            t(k), t(v))
    got = tk8.paged_prefill_attention_batched(*args, scale=scale, **pool).reshape(B, C, H, dh)
    np.testing.assert_allclose(got.numpy(), out["kernel"], **TOL)
    valid = np.asarray(positions) >= 0
    np.testing.assert_allclose(got.numpy()[valid], out["ref"][valid], **TOL)
    assert not got[~torch.from_numpy(valid)].any()
    for b in (0, 2, 3):
        n = int(valid[b].sum())
        one = tk8.paged_prefill_attention(args[0][b, :n], pk, pv, args[3], tbl[b], args[5][b, :n],
                                          args[6][b, :n], args[7][b, :n], scale=scale, **pool)
        assert torch.equal(one, got.reshape(B, C, Hkv, H // Hkv, dh)[b, :n])


# ---------------------------------------------------------------------------
# Model entries
# ---------------------------------------------------------------------------


def assert_pools_close(tcfg, tcaches, jcaches):
    """Every paged layer's pool (the trash page aside) as JAX's."""
    for sk, pk, _, paged in tm._layer_entries(tcfg):
        if paged:
            for tt, jj in leaves_like(tcaches[sk][pk]["self"], jcaches[sk][pk]["self"]):
                np.testing.assert_allclose(tt.numpy()[:, :-1], np.asarray(jj)[:, :-1], **TOL)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_prefill_chunk_batched_matches_jax(glm4, kv_bits):
    """Two batched calls over 3 slots: first row 0's 8-token chunk and row 2's
    5-token one (row 1 inactive), then row 0's next 6 tokens over its
    history (rows 1 and 2 inactive).  Logits of the active rows and the
    pools agree with JAX's."""
    jcfg, tcfg, jparams, tparams = glm4
    S, C, MP, n_pages, ps = 3, 8, 8, 12, 4
    kw = dict(capacity=32, kv_bits=kv_bits, page_size=ps)
    jc = jm.init_paged_caches(jcfg, S, 32, n_pages=n_pages, page_size=ps, kv_bits=kv_bits)
    tc = tm.init_paged_caches(tcfg, S, 32, n_pages=n_pages, page_size=ps, kv_bits=kv_bits,
                              device="cpu")
    rng = np.random.default_rng(3)
    ctx0, ctx2 = rng.integers(1, 500, 14), rng.integers(1, 500, 5)
    tables = np.full((S, MP), -1, np.int32)
    tables[0, :4], tables[2, :2] = [5, 1, 9, 3], [0, 7]
    calls = [((0, 0, 8), (2, 0, 5)), ((0, 8, 14),)]
    for first, rows in enumerate(calls):
        toks, pos = np.zeros((S, C), np.int32), np.full((S, C), -1, np.int32)
        active, reset, last = np.zeros(S, bool), np.zeros(S, bool), np.zeros(S, np.int32)
        tbl = np.full((S, MP), -1, np.int32)
        for i, a, b in rows:
            toks[i, : b - a] = (ctx0 if i == 0 else ctx2)[a:b]
            pos[i, : b - a] = np.arange(a, b)
            active[i], reset[i], last[i], tbl[i] = True, first == 0, b - a - 1, tables[i]
        jl, jc = jm.paged_prefill_chunk_batched(
            jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(reset),
            jnp.asarray(active), jnp.asarray(last), jc, jnp.asarray(tbl), **kw)
        tl, tc = tm.paged_prefill_chunk_batched(
            tcfg, tparams, t(toks).long(), t(pos), t(reset), t(active), t(last), tc, t(tbl))
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active], **TOL)
    assert_pools_close(tcfg, tc, jc)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_paged_prefill_into_slot_matches_jax(glm4, kv_bits):
    """The scatter oracle over a table whose first two pages are shared
    (``scatter_start`` 8): the shared pages keep their contents, the rest
    receive the prompt's K/V and positions, logits as JAX's."""
    jcfg, tcfg, jparams, tparams = glm4
    n_pages, ps = 10, 4
    jc = jm.init_paged_caches(jcfg, 2, 32, n_pages=n_pages, page_size=ps, kv_bits=kv_bits)
    rng = np.random.default_rng(4)
    jc = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))
                      if x.dtype == jnp.float32 else x, jc)
    tc = tm.init_paged_caches(tcfg, 2, 32, n_pages=n_pages, page_size=ps, kv_bits=kv_bits,
                              device="cpu")
    copy_into(tc, jc)
    toks = rng.integers(1, 500, (1, 11)).astype(np.int32)
    pos = np.arange(11, dtype=np.int32)[None]
    row = np.full((8,), -1, np.int32)
    row[:3] = [4, 2, 8]
    jl, jc = jm.paged_prefill_into_slot(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos),
                                        jnp.asarray(1, jnp.int32), jc, jnp.asarray(row),
                                        capacity=32, kv_bits=kv_bits, scatter_start=8)
    tl, tc = tm.paged_prefill_into_slot(tcfg, tparams, t(toks).long(), t(pos), tc, t(row),
                                        scatter_start=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_pools_close(tcfg, tc, jc)


# ---------------------------------------------------------------------------
# The engine: batched tick (TestBatchedPrefillTick) and the scatter oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", [False, True])
def test_batched_matches_jax_and_chunked(glm4, prefix):
    """Five prompts onto 4 slots, several mid-prefill in one batched call;
    the queued fifth repeats the preamble and, with sharing, hits it.  The
    port's batched engine equals JAX's in every record, and its tokens its
    own chunked engine's."""
    rng = np.random.RandomState(0)
    prompts = ([PRE + [int(x) for x in rng.randint(1, 97, size=n)] for n in (13, 1)]
               + [[9, 8, 7], [1, 2]] + [PRE + [int(x) for x in rng.randint(1, 97, size=5)]])
    kw = dict(PAGED, slots=4, prefill_chunk=8, prefix_sharing=prefix)
    jr, tr, eng = both(glm4, serve(prompts, 6), prefill_mode="batched", **kw)
    assert tr == jr and tr["free"] == eng.n_pages
    assert any(m["batched_prefill_occupancy"] > 0.25 for m in eng.metrics_log)
    if prefix:
        assert tr["prefix_hits"] >= 1
    _, tcfg, _, tparams = glm4
    chunked = serve(prompts, 6)(ContinuousEngine(tcfg, tparams, device="cpu",
                                                 prefill_mode="chunked", **kw), Request)
    assert tr["tokens"] == chunked["tokens"]


def test_one_prefill_call_per_tick(glm4, monkeypatch):
    """Three concurrent admissions advance in ONE model call per tick: the
    batched attention runs once per layer per tick that prefills, the
    single-row one never."""
    _, tcfg, _, tparams = glm4
    calls = {"batched": 0, "single": 0}
    batched, single = tattn.paged_prefill_attention_batched, tattn.paged_prefill_attention

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tattn, "paged_prefill_attention_batched", count("batched", batched))
    monkeypatch.setattr(tattn, "paged_prefill_attention", count("single", single))
    eng = ContinuousEngine(tcfg, tparams, device="cpu", slots=4, prefill_chunk=4,
                           prefill_mode="batched", **PAGED)
    for i in range(3):
        eng.submit(Request(prompt=list(range(1, 22 + i)), max_new_tokens=4))
    assert calls["batched"] == 0  # admission launches nothing in batched mode
    eng.step()
    m = eng.metrics_log[-1]
    assert m["prefill_tokens"] == 12 and m["prefill_calls"] == 1
    assert m["batched_prefill_occupancy"] == 0.75
    eng.run_until_done()
    ticks = [m for m in eng.metrics_log if m["prefill_tokens"]]
    assert all(m["prefill_calls"] == 1 for m in ticks)
    assert calls == {"batched": tcfg.num_layers * len(ticks), "single": 0}
    assert eng.prefill_calls_total == len(ticks)


def test_batched_preemption_resumes_exactly(glm4):
    """A tight pool preempts under the batched tick; the victim resumes
    token-exact: as JAX's batched engine and the port's chunked one."""
    prompts = [list(range(1, 41)), [5, 4, 3]]
    kw = dict(slots=2, capacity=48, paged=True, page_size=4, n_pages=12, prefill_chunk=4)
    jr, tr, eng = both(glm4, serve(prompts, 8), prefill_mode="batched", **kw)
    assert tr == jr and tr["preemptions"] >= 1 and tr["free"] == eng.n_pages
    _, tcfg, _, tparams = glm4
    chunked = serve(prompts, 8)(ContinuousEngine(tcfg, tparams, device="cpu",
                                                 prefill_mode="chunked", **kw), Request)
    assert tr["tokens"] == chunked["tokens"]


def test_batched_requires_paged(glm4):
    with pytest.raises(ValueError, match="batched.*paged"):
        ContinuousEngine(glm4[1], glm4[3], device="cpu", slots=2, capacity=16,
                         prefill_mode="batched")


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_chunked_matches_scatter_greedy(glm4, kv_bits, prefix):
    """The scatter oracle: the port's scatter engine equals JAX's in every
    record, and the port's chunked engine (4-token chunks) gives its
    tokens."""
    prompts = [PRE + [11], PRE + [12, 13], [9, 8, 7], PRE + [14, 15, 16]]
    kw = dict(PAGED, slots=3, kv_cache_bits=kv_bits, n_pages=24, prefix_sharing=prefix)
    jr, tr, eng = both(glm4, serve(prompts, 5), prefill_mode="scatter", **kw)
    assert tr == jr and tr["free"] == eng.n_pages
    if prefix:
        assert tr["prefix_hits"] >= 1
    _, tcfg, _, tparams = glm4
    chunked = serve(prompts, 5)(ContinuousEngine(tcfg, tparams, device="cpu",
                                                 prefill_mode="chunked", prefill_chunk=4, **kw),
                                Request)
    assert tr["tokens"] == chunked["tokens"]


def test_batched_capacity_drops_as_the_jax_kernel_path(monkeypatch):
    """Reduced llama4 under its own capacity dispatch (``ep``: the dense
    mapping table), a router skewed toward expert 0: the batched calls'
    padded tokens compete for capacity beside the real ones, and calls
    drop.  Tokens and records equal the JAX engine's on its kernel path
    (Pallas in interpret mode), whose padded queries see attention 0 as the
    port's do."""
    jcfg, tcfg, jparams, _ = load("llama4-maverick-400b-a17b")
    tree = jax.tree.map(np.array, jparams)
    v = np.random.default_rng(7).standard_normal(jcfg.d_model).astype(np.float32)
    v /= np.linalg.norm(v)
    tree["embed"] += 0.5 * v
    tree["segments"]["seg0"]["pos1"]["moe"]["router"][..., 0] += 0.05 * v
    tparams = convert.params_from_numpy(tcfg, tree, "cpu")
    kw = dict(slots=3, capacity=32, paged=True, page_size=4, prefill_chunk=8, n_pages=24,
              prefill_mode="batched")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 500, n).tolist() for n in (13, 5, 10, 3)]
    drops = []
    gate = tmoe.gating

    def record_gating(logits, top_k, capacity, **k):
        g, counts = gate(logits, top_k, capacity, **k)
        if logits.shape[0] == kw["slots"] * kw["prefill_chunk"]:
            drops.append(int((~g.keep).sum()))
        return g, counts

    monkeypatch.setattr(tmoe, "gating", record_gating)
    tr = serve(prompts, 4)(ContinuousEngine(tcfg, tparams, device="cpu", **kw), Request)
    assert drops and max(drops) > 0, drops
    jattn.set_paged_backend("kernel")
    try:
        jr = serve(prompts, 4)(JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree), **kw), JaxRequest)
    finally:
        jattn.set_paged_backend(None)
    assert tr == jr
