"""Port parity for sliding-window (ring) attention: the window mask, query
chunking of a local layer, the ring writes of ``models/attention.py``,
kernel 9's plain version with a window over a wrapped int8 ring, the local
attention layer, and gemma3-27b (5 local : 1 global) through the static
``Engine`` and every ``ContinuousEngine`` mode, against the JAX package on
the CPU in f32 (the cases of ``tests/test_attention.py:60-95``,
``tests/test_serving.py:46`` and ``tests/test_kv_quant.py:98, 185``).

Inputs are drawn with numpy from fixed seeds; the JAX side is jitted where
it has a function to jit.  Tolerances: attention outputs ``1e-4`` (the
query-chunked cases, as ``test_attention.py``) or ``2e-5`` (layer-level,
the order of summation alone differs); int8 ring contents byte-exact (both
packages quantize each token alone); logits past the window ``5e-3``
against the full forward (``test_serving.py``), ``2e-4`` against JAX; greedy
tokens identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnSpec as JAttnSpec
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.kernels.attention_quant import decode_attention_quant as jax_k9
from repro.kernels.attention_quant import decode_attention_quant_ref as jax_k9_ref
from repro.models import attention as jattn
from repro.models import model as jm
from repro.quant.kv import kv_quantize_values as jax_kvq
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Engine as JaxStatic
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.base import AttnSpec
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.kernels import attention_quant as k9
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.models.transformer import take
from repro_torch.quant.kv import QuantizedKV, kv_quantize_values
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=2e-5, rtol=1e-4)
PRE = [7, 7, 3, 5, 1, 2, 9, 4]  # 2 full pages at page_size=4: a shared preamble
# prompts past the reduced window (8) and one of exactly a window, with their
# new tokens; the third, admitted while the first still decodes, finds the
# preamble's pages indexed.  Chunks of 8 split them into chunks of 8 and one
# of 5 (few shapes for the JAX engine to compile)
PROMPTS = [PRE + list(range(11, 19)), list(range(1, 9)), PRE + [13, 14, 15, 16, 17],
           list(range(1, 25)), PRE + list(range(21, 29))]
NEW = [10, 6, 6, 6, 6]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _qkv(B, S, H, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, dh), (B, S, Hkv, dh), (B, S, Hkv, dh)))


# ---------------------------------------------------------------------------
# Mask and query chunking (test_attention.py:60-95)
# ---------------------------------------------------------------------------


def test_window_mask_matches_jax():
    q_pos = np.arange(8, dtype=np.int32)[None]
    k_pos = np.array([[0, 1, -1, 3, 4, 5, 6, 7]], np.int32)
    m = tattn._window_causal_mask(*_t(q_pos, k_pos), 3, True)[0, 0, 0].numpy()
    np.testing.assert_array_equal(m, np.asarray(jattn._window_causal_mask(q_pos, k_pos, 3, True))[0, 0, 0])
    for i in range(8):
        for j in range(8):
            assert m[i, j] == (j <= i and i - j < 3 and j != 2), (i, j)


@pytest.mark.parametrize("kind,window", [("global", 0), ("local", 512), ("local", 100)])
def test_chunked_equals_full(kind, window):
    """Kernel 6's plain version (1024 queries at a time) against JAX's
    ``attend_full`` and its query-chunked ``attend_chunked`` (a local layer
    reads only the window's K/V per 512-query chunk)."""
    B, S = 1, 2048
    q, k, v = _qkv(B, S, 2, 1, 8, seed=3)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    spec, jspec = AttnSpec(kind=kind, window=window), JAttnSpec(kind=kind, window=window)
    got = tattn.attend_chunked(*_t(q, k, v, pos, pos), spec, 0.3).numpy()
    jfull = jax.jit(lambda *a: jattn.attend_full(*a, jspec, 0.3))(q, k, v, pos, pos)
    jchunk = jax.jit(lambda *a: jattn.attend_chunked(*a, jspec, 0.3, q_chunk=512))(q, k, v, pos, pos)
    np.testing.assert_allclose(got, np.asarray(jfull), **TOL)
    np.testing.assert_allclose(got, np.asarray(jchunk), **TOL)


@pytest.mark.parametrize("window,seed", [(64, 0), (200, 7), (513, 13)])
def test_local_window_chunks(window, seed):
    """``test_property_local_window_chunks`` at fixed draws."""
    B, S = 1, 1024
    q, k, v = _qkv(B, S, 2, 1, 8, seed=seed)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    spec, jspec = AttnSpec(kind="local", window=window), JAttnSpec(kind="local", window=window)
    got = tattn.attend_chunked(*_t(q, k, v, pos, pos), spec, 0.3).numpy()
    want = jax.jit(lambda *a: jattn.attend_chunked(*a, jspec, 0.3, q_chunk=256))(q, k, v, pos, pos)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Ring writes
# ---------------------------------------------------------------------------


def _caches(B, cap, kv_bits, seed=0):
    """A port ring and the JAX one with the same contents: half its slots
    written with positions 100.., the rest empty."""
    tc = tattn.init_kv_cache(B, cap, 2, 16, torch.float32, "cpu", kv_bits=kv_bits)
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal((2, B, cap // 2, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 100 + cap // 2, dtype=np.int32), (B, cap // 2)).copy()
    tattn._cache_write_prefill(tc, *_t(kv[0], kv[1], pos))
    jc = jattn._cache_write_prefill(jattn.init_kv_cache(B, cap, 2, 16, jnp.float32, kv_bits=kv_bits),
                                    jnp.asarray(kv[0]), jnp.asarray(kv[1]), jnp.asarray(pos))
    return tc, jc


def _assert_same(tc, jc, exact=True):
    """Ring contents: the same positions, and the same bytes (``exact``: the
    same values written) or, for values the two packages computed, fp
    entries within LAYER_TOL and int8 ones within one quantization step."""
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        if isinstance(tc[name], QuantizedKV):
            got, want = tc[name], jc[name]
            if exact:
                np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
                np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-7)
            else:
                step = float(np.asarray(want.scale).max())
                np.testing.assert_allclose(got.dequantize().numpy(),
                                           np.asarray(want.q * want.scale), atol=1.01 * step)
        elif exact:
            np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
        else:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **LAYER_TOL)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_ring_writes_match_jax(kv_bits):
    """A prefill longer than the ring keeps its last cap tokens at slot
    ``p % cap``; a chunk resumes mid-ring (and one longer than the ring
    rebuilds it); a batched chunk keeps each row's last cap valid tokens and
    drops padding.  Contents as JAX's, byte for byte."""
    cap = 8
    rng = np.random.default_rng(1)
    # a prefill of 12 tokens into an empty ring of 8
    tc = tattn.init_kv_cache(2, cap, 2, 16, torch.float32, "cpu", kv_bits=kv_bits)
    jc = jattn.init_kv_cache(2, cap, 2, 16, jnp.float32, kv_bits=kv_bits)
    k, v = rng.standard_normal((2, 2, 12, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    tattn._cache_write_prefill(tc, *_t(k, v, pos))
    jc = jattn._cache_write_prefill(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    _assert_same(tc, jc)
    # chunks resuming it: 5 tokens from position 12 (mid-ring), then 11 (> cap)
    for start, C in ((12, 5), (17, 11)):
        k, v = rng.standard_normal((2, 2, C, 2, 16)).astype(np.float32)
        pos = np.broadcast_to(np.arange(start, start + C, dtype=np.int32), (2, C)).copy()
        tattn._cache_write_chunk(tc, *_t(k, v, pos))
        jc = jattn._cache_write_chunk(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        _assert_same(tc, jc)
    # a batched chunk: row 0 of 11 valid tokens (> cap), row 1 of 3 then
    # padding, row 2 of 6; rows start mid-ring
    tc, jc = _caches(3, cap, kv_bits, seed=2)
    k, v = rng.standard_normal((2, 3, 11, 2, 16)).astype(np.float32)
    pos = np.full((3, 11), -1, np.int32)
    pos[0] = np.arange(104, 115)
    pos[1, :3] = np.arange(104, 107)
    pos[2, :6] = np.arange(104, 110)
    tattn._cache_write_chunk_batched(tc, *_t(k, v, pos))
    jc = jattn._cache_write_chunk_batched(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    _assert_same(tc, jc)


def test_int8_ring_prefill_write():
    """``test_kv_quant.py:185``: cap < S, the last cap tokens land at slot
    ``p % cap``, quantized."""
    cap, S = 8, 12
    c = tattn.init_kv_cache(1, cap, 2, 16, torch.float32, "cpu", kv_bits=8)
    k = torch.from_numpy(np.random.default_rng(0).standard_normal((1, S, 2, 16)).astype(np.float32))
    tattn._cache_write_prefill(c, k, k, torch.arange(S, dtype=torch.int32)[None])
    got = c["k"].dequantize()
    for p in range(S - cap, S):
        want = QuantizedKV.quantize(k[:, p : p + 1]).dequantize()[0, 0]
        np.testing.assert_allclose(got[0, p % cap].numpy(), want.numpy(), atol=1e-6)
        assert int(c["pos"][0, p % cap]) == p


# ---------------------------------------------------------------------------
# Kernel 9 with a window over a ring (test_kv_quant.py:98)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (0, 30.0)])
def test_decode_quant_plain_matches_jax(window, softcap):
    B, T, Hkv, G, dh = 3, 48, 2, 3, 16
    rng = np.random.default_rng(window + int(softcap))
    k, v = rng.standard_normal((2, B, T, Hkv, dh)).astype(np.float32)
    q = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    kq, ks = jax_kvq(jnp.asarray(k))
    vq, vs = jax_kvq(jnp.asarray(v))
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    kpos[:, 40:] = -1  # empty ring slots
    qpos = np.full((B, 1), 39, np.int32)
    kw = dict(scale=0.25, window=window, softcap=softcap)
    got = k9.decode_attention_quant(*_t(q, kq, ks, vq, vs, kpos, qpos[:, 0]), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_k9_ref(q, kq, ks, vq, vs, kpos, qpos, **kw)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_k9(q, kq, ks, vq, vs, kpos, qpos, **kw)), atol=1e-5)


@pytest.mark.parametrize("dh", [16, 256])
def test_decode_quant_split_over_a_wrapped_ring(dh):
    """A ring whose newest key sits before its oldest in memory (slot p %
    cap), under the window: the bf16 kernel's plan (``live_tiles``,
    ``split_tiles``) takes exactly the tiles that hold a key the query sees,
    and its split-K arithmetic equals the plain version, at head dims 16 and
    256 (recurrentgemma's)."""
    B, cap, Hkv, G = 3, 256, 1, 2
    rng = np.random.default_rng(dh)
    k, v = (torch.from_numpy(rng.standard_normal((B, cap, Hkv, dh)).astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, dh)).astype(np.float32))
    kq, ks = kv_quantize_values(k)
    vq, vs = kv_quantize_values(v)
    qpos = torch.tensor([300, 1000, 70], dtype=torch.int32)  # rows 0 and 1 wrapped, row 2 not
    slot = torch.arange(cap)
    kpos = torch.stack([torch.where(slot <= p % cap, p - p % cap + slot, p - p % cap - cap + slot)
                        for p in qpos.tolist()]).to(torch.int32)
    kpos[2, 71:] = -1
    window = 200
    for b in range(B):
        valid = (kpos[b] >= 0) & (kpos[b] <= qpos[b]) & (qpos[b] - kpos[b] < window)
        want = sorted({int(i) // 64 for i in torch.nonzero(valid).flatten()})
        assert k9.live_tiles(kpos[b], int(qpos[b]), window=window) == want
        assert sorted(sum(k9.split_tiles(kpos[b], int(qpos[b]), 3, window=window), [])) == want
    kw = dict(scale=dh ** -0.5, window=window)
    plain = k9.decode_attention_quant_plain(q, kq, ks, vq, vs, kpos, qpos, **kw)
    split = k9.decode_attention_quant_split(q, kq, ks, vq, vs, kpos, qpos, 3, **kw)
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The local attention layer and gemma3 (test_serving.py:46)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def gemma3():
    jcfg = jax_make_reduced(jax_get_config("gemma3-27b"))
    tcfg = make_reduced(get_config("gemma3-27b"))
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_local_layer_matches_jax(kv_bits):
    """gemma3's first (local, qk-norm) layer: a 12-token prefill into its
    ring of 8, 6 decode steps past the window, then two resumed chunks
    starting mid-ring: outputs and ring contents as JAX's (fp within
    LAYER_TOL, int8 within one quantization step)."""
    jcfg, tcfg, jparams, tparams = gemma3()
    jspec, tspec = jcfg.segments[0].pattern[0].mixer, tcfg.segments[0].pattern[0].mixer
    assert tspec.kind == "local" and tspec.qk_norm and tspec.window == 8
    jp = jax.tree.map(lambda a: a[0], jparams["segments"]["seg0"]["pos0"]["attn"])
    tp = take(tparams["segments"]["seg0"]["pos0"]["attn"], 0)
    B, D = 2, tcfg.d_model
    tc = tattn.init_kv_cache(B, 8, tcfg.num_kv_heads, tcfg.head_dim, torch.float32, "cpu",
                             kv_bits=kv_bits)
    jc = jattn.init_kv_cache(B, 8, jcfg.num_kv_heads, jcfg.head_dim, jnp.float32, kv_bits=kv_bits)
    rng = np.random.default_rng(5)
    jf = jax.jit(lambda p, x, pos, c, mode: jattn.attention(jcfg, jspec, p, x, pos, cache=c, mode=mode),
                 static_argnums=4)

    def step(x, pos, mode, **kw):
        nonlocal jc
        ty, _ = tattn.attention(tcfg, tspec, tp, *_t(x, pos), cache=tc, mode=mode, **kw)
        jy, jc = jf(jp, x, pos, jc, mode)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        _assert_same(tc, jc, exact=False)

    x = rng.standard_normal((B, 12, D)).astype(np.float32)
    step(x, np.arange(12, dtype=np.int32)[None], "prefill")
    for i in range(12, 18):
        step(rng.standard_normal((B, 1, D)).astype(np.float32), np.full((B, 1), i, np.int32),
             "decode", index=i)
    for start, C in ((18, 5), (23, 5)):
        step(rng.standard_normal((B, C, D)).astype(np.float32),
             np.arange(start, start + C, dtype=np.int32)[None], "prefill_chunk")


def test_window_cache_beyond_window():
    """Decoding past the window stays exact: prefill 10, decode 8 more
    (window 8), logits against the full forward (5e-3) and JAX (2e-4)."""
    jcfg, tcfg, jparams, tparams = gemma3()
    B, S, extra = 1, 10, 8
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S + extra)).astype(np.int64)
    full, _ = tm.forward(tcfg, tparams, torch.from_numpy(toks))
    jfull, _ = jax.jit(lambda p, t: jm.forward(jcfg, p, t))(jparams, toks.astype(np.int32))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=2e-4, rtol=2e-4)
    caches = tm.init_caches(tcfg, B, S + extra, device="cpu")
    _, caches = tm.prefill(tcfg, tparams, torch.from_numpy(toks[:, :S]), caches)
    for i in range(extra):
        lg, caches = tm.decode_step(tcfg, tparams, torch.from_numpy(toks[:, S + i : S + i + 1]), S + i,
                                    caches)
        np.testing.assert_allclose(lg.numpy(), full[:, S + i].numpy(), atol=5e-3, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# gemma3 through the engines, against the JAX engines
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_tokens(kind, kv_bits):
    """The JAX engine's greedy tokens on PROMPTS: the static engine, or the
    paged continuous engine (chunked, prefix sharing on)."""
    jcfg, _, jparams, _ = gemma3()
    if kind == "static":
        eng = JaxStatic(jcfg, jparams, JaxEngineConfig(max_batch=5, max_prefill=24, max_decode=10,
                                                       kv_cache_bits=kv_bits))
        return [r.tokens for r in eng.generate([JaxRequest(p, n) for p, n in zip(PROMPTS, NEW)])]
    eng = JaxEngine(jcfg, jparams, kv_cache_bits=kv_bits, **PAGED, prefix_sharing=True)
    ids = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n)) for p, n in zip(PROMPTS, NEW)]
    done = eng.run_until_done()
    return [done[i].tokens for i in ids], eng.preemptions


PAGED = dict(slots=2, capacity=40, paged=True, page_size=4, n_pages=20, prefill_chunk=8)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_static_engine_matches_jax(kv_bits):
    """Prompts of 3-20 tokens past the window of 8 (fp and int8 rings)."""
    _, tcfg, _, tparams = gemma3()
    eng = Engine(tcfg, tparams, EngineConfig(max_batch=5, max_prefill=24, max_decode=10,
                                             kv_cache_bits=kv_bits), device="cpu")
    got = eng.generate([Request(p, n) for p, n in zip(PROMPTS, NEW)])
    assert [r.tokens for r in got] == jax_tokens("static", kv_bits)


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("mode,prefix", [("chunked", False), ("chunked", True), ("batched", False),
                                         ("batched", True), ("scatter", True), ("contiguous", False)])
def test_continuous_engine_matches_jax(mode, prefix, kv_bits):
    """Every mode, prefix sharing on and off, fp and int8 KV: the JAX
    engine's tokens and preemptions (the JAX engines' modes agree with one
    another, ``tests/test_chunked.py``).  Under sharing the prefix is
    recomputed (rings are rebuilt), so no prefill token is skipped."""
    _, tcfg, _, tparams = gemma3()
    if mode == "contiguous":
        kw = dict(slots=2, capacity=40, kv_cache_bits=kv_bits)
    else:
        kw = dict(PAGED, prefill_mode=mode, prefix_sharing=prefix, kv_cache_bits=kv_bits)
    eng = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    ids = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(PROMPTS, NEW)]
    done = eng.run_until_done()
    assert ([done[i].tokens for i in ids], eng.preemptions) == jax_tokens("paged", kv_bits)
    if eng.paged:
        assert eng.pool.free_count == eng.n_pages
        eng.pool.check()
    if prefix:
        assert eng.prefix_hits >= 1 and eng.prefill_tokens_skipped == 0
