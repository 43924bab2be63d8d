"""Port parity for the int8 KV cache: ``QuantizedKV``, quantize-on-write in
the contiguous and paged caches, the plain versions of the int8 decode
kernel (kernel 9) and of the int8 branches of the paged kernels (7q, 8q),
and the paged ``ContinuousEngine`` with int8 experts and an int8 pool,
against the JAX package on the same numpy inputs, on the CPU.

Tolerances: quantized values, scales, positions and byte counts are exact;
f32 attention outputs agree to 1e-5 (the same products summed in another
order); greedy tokens and preemption counts are identical.  The port's
kernels and plain versions give a row with no valid key 0 (masked
probabilities zeroed); the JAX ``_ref`` oracles, and the JAX kernel 9
itself, give such a row a uniform average, so they are compared on rows
that have a valid key.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.kernels import attention_paged as jk7
from repro.kernels import attention_prefill_paged as jk8
from repro.kernels import attention_quant as jk9
from repro.models import attention as jattn
from repro.models import model as jm
from repro.quant import kv as jkv
from repro.quant import quantize_params as jquantize_params
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.kernels import attention_paged as tk7
from repro_torch.kernels import attention_prefill_paged as tk8
from repro_torch.kernels import attention_quant as tk9
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.quant import kv as tkv
from repro_torch.quant import quantize_params
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Request
from test_torch_paged import chunk_case, decode_case
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_kv_equal(tkv_, jkv_):
    np.testing.assert_array_equal(tkv_.q.numpy(), np.asarray(jkv_.q))
    np.testing.assert_array_equal(tkv_.scale.numpy(), np.asarray(jkv_.scale))


# ---------------------------------------------------------------------------
# QuantizedKV: byte-exact with JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_values_match_jax(dtype):
    """Per-(timestep, head) scales, an all-zero slot, and the dequantized
    values, bit for bit."""
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 8)).astype(np.float32) * 3
    x[0, 1] = 0.0  # an all-zero timestep
    x[1, 2, 0] *= 1e3  # one loud (timestep, head) does not touch its neighbours
    jx = jnp.asarray(x).astype(dtype)
    ja = jkv.QuantizedKV.quantize(jx)
    ta = tkv.QuantizedKV.quantize(t(jx.astype(jnp.float32)).to(getattr(torch, dtype)))
    assert_kv_equal(ta, ja)
    np.testing.assert_array_equal(ta.dequantize().float().numpy(),
                                  np.asarray(ja.dequantize().astype(jnp.float32)))
    assert ta.nbytes == ja.nbytes and ta.shape == ja.shape
    assert (ta.dequantize()[0, 1] == 0).all()


def test_cache_bytes_and_layout():
    """``kv_cache_bytes`` of int8 caches equals JAX's, contiguous and paged;
    kv_bits other than 0 and 8 raise as in JAX."""
    name = "llama4-maverick-400b-a17b"
    jcfg, tcfg = jax_make_reduced(jax_get_config(name)), make_reduced(get_config(name))
    for kv_bits in (0, 8):
        jb = jkv.kv_cache_bytes(jax.eval_shape(lambda: jm.init_caches(jcfg, 3, 20, kv_bits=kv_bits)))
        tb = tkv.kv_cache_bytes(tm.init_caches(tcfg, 3, 20, kv_bits=kv_bits, device="meta"))
        assert tb == jb
        jb = jkv.kv_cache_bytes(jax.eval_shape(lambda: jm.init_paged_caches(
            jcfg, 3, 20, n_pages=7, page_size=4, kv_bits=kv_bits)))
        tb = tkv.kv_cache_bytes(tm.init_paged_caches(tcfg, 3, 20, n_pages=7, page_size=4,
                                                     kv_bits=kv_bits, device="meta"))
        assert tb == jb
    c = tm.init_caches(tcfg, 2, 8, kv_bits=8, device="cpu")["seg0"]["pos0"]["self"]
    assert c["k"].q.dtype == torch.int8 and c["k"].scale.shape == c["k"].q.shape[:-1] + (1,)
    assert (c["k"].dequantize() == 0).all()
    for bad in (4, 16):
        with pytest.raises(ValueError, match="kv_bits"):
            tattn.init_kv_cache(1, 4, 2, 8, torch.float32, "cpu", kv_bits=bad)
        with pytest.raises(ValueError, match="kv_bits"):
            tattn.init_paged_kv_cache(2, 4, 2, 8, torch.float32, "cpu", kv_bits=bad)


# ---------------------------------------------------------------------------
# Quantize-on-write at every write site
# ---------------------------------------------------------------------------


def as_jax(c):
    return {k: (jkv.QuantizedKV(jnp.asarray(v.q.numpy()), jnp.asarray(v.scale.numpy()), "float32")
                if isinstance(v, tkv.QuantizedKV) else jnp.asarray(v.numpy())) for k, v in c.items()}


def assert_cache_equal(tc, jc, skip_trash=False):
    sl = slice(None, -1) if skip_trash else slice(None)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_array_equal(tc[key].q.numpy()[sl], np.asarray(jc[key].q)[sl])
        np.testing.assert_array_equal(tc[key].scale.numpy()[sl], np.asarray(jc[key].scale)[sl])


def test_contiguous_writes_match_jax():
    """Static prefill and decode writes quantize in place to JAX's bytes."""
    rng = np.random.default_rng(1)
    B, S, Hkv, dh, cap = 2, 5, 2, 8, 9
    tc = tattn.init_kv_cache(B, cap, Hkv, dh, torch.float32, "cpu", kv_bits=8)
    jc = jattn.init_kv_cache(B, cap, Hkv, dh, jnp.float32, kv_bits=8)
    k, v = (rng.standard_normal((B, S, Hkv, dh)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    tc = tattn._cache_write_prefill(tc, t(k), t(v), t(pos))
    jc = jattn._cache_write_prefill(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    assert_cache_equal(tc, jc)
    for index in (S, S + 1):
        k1, v1 = (rng.standard_normal((B, 1, Hkv, dh)).astype(np.float32) for _ in range(2))
        tc = tattn._cache_write_decode(tc, t(k1), t(v1), index)
        jc = jattn._cache_write_decode(jc, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(index))
        assert_cache_equal(tc, jc)


def test_paged_writes_match_jax():
    """Paged decode (an inactive row routed to the trash page) and chunk
    writes (entries already holding their position routed to the trash
    page) quantize in place to JAX's bytes; ``already`` reads pos first."""
    rng = np.random.default_rng(2)
    Pt, ps, Hkv, dh = 10, 4, 2, 8
    tc = tattn.init_paged_kv_cache(Pt - 1, ps, Hkv, dh, torch.float32, "cpu", kv_bits=8)
    kpos = np.full((Pt, ps), -1, np.int32)
    kpos[3] = np.arange(4)
    kpos[7, :2] = [4, 5]
    tc["pos"].copy_(t(kpos))
    jc = as_jax(tc)
    table = np.array([[3, 7, 1, Pt - 1], [Pt - 1] * 4], np.int32)
    # decode: row 0 at position 6 (page 7), row 1 inactive (all trash)
    k1, v1 = (rng.standard_normal((2, 1, Hkv, dh)).astype(np.float32) for _ in range(2))
    row_pos = np.array([6, 3], np.int32)
    tc = tattn._paged_cache_write_decode(tc, t(k1), t(v1), t(row_pos), t(table))
    jc = jattn._paged_cache_write_decode(jc, jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(row_pos),
                                         jnp.asarray(table))
    assert_cache_equal(tc, jc, skip_trash=True)
    # chunk: positions 5..8, position 5 already held by page 7
    kc, vc = (rng.standard_normal((1, 4, Hkv, dh)).astype(np.float32) for _ in range(2))
    positions = np.arange(5, 9, dtype=np.int32)
    held = tc["k"].q[7, 1].clone()
    tc = tattn._paged_cache_write_chunk(tc, t(kc), t(vc), t(positions), t(table[0]))
    jc = jattn._paged_cache_write_chunk(jc, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(positions),
                                        jnp.asarray(table[0]))
    assert_cache_equal(tc, jc, skip_trash=True)
    assert torch.equal(tc["k"].q[7, 1], held) and (tc["pos"][-1] == -1).all()


# ---------------------------------------------------------------------------
# Kernel 9 and the int8 branches of kernels 7 and 8 (plain versions)
# ---------------------------------------------------------------------------


def quant_pool(k, v):
    """fp K/V -> (kq, ks, vq, vs) as numpy, through the JAX quantizer."""
    kq, ks = (np.asarray(a) for a in jkv.kv_quantize_values(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jkv.kv_quantize_values(jnp.asarray(v)))
    return kq, ks, vq, vs


def kernel9_case(seed=0):
    """4 rows over a contiguous cache of T = 11 slots: row 0 full, row 1 a
    prefix of 6, row 2 a ring whose slot 0 holds position 11, row 3 empty
    (no valid key)."""
    rng = np.random.default_rng(seed)
    B, Hkv, G, dh, T = 4, 2, 3, 8, 11
    q = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, dh)).astype(np.float32) for _ in range(2))
    kpos = np.full((B, T), -1, np.int32)
    kpos[0] = np.arange(T)
    kpos[1, :6] = np.arange(6)
    kpos[2] = np.arange(T)
    kpos[2, 0] = 11
    qpos = np.array([10, 5, 11, 4], np.int32)
    return q, *quant_pool(k, v), kpos, qpos


@pytest.mark.parametrize("kw", [dict(scale=0.35), dict(scale=0.35, window=4, softcap=5.0)],
                         ids=["plain", "window_softcap"])
def test_decode_attention_quant_plain_matches_jax(kw):
    """Kernel 9's plain version against ``decode_attention_quant_ref`` on the
    rows with a valid key; the row with none gives 0 here, a uniform average
    there."""
    q, kq, ks, vq, vs, kpos, qpos = kernel9_case()
    jargs = tuple(jnp.asarray(a) for a in (q, kq, ks, vq, vs, kpos, qpos[:, None]))
    got = tk9.decode_attention_quant(*(t(a) for a in (q, kq, ks, vq, vs, kpos, qpos)), **kw).numpy()
    ref = np.asarray(jk9.decode_attention_quant_ref(*jargs, **kw))
    np.testing.assert_allclose(got[:3], ref[:3], **TOL)
    assert np.all(got[3] == 0)  # no valid key: 0, finite
    assert np.isfinite(ref[3]).all() and np.abs(ref[3]).max() > 0  # JAX: a uniform average
    assert tk9.launches["decode_attention_quant"] == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("kw", [dict(scale=0.35), dict(scale=0.35, window=3, softcap=5.0)],
                         ids=["plain", "window_softcap"])
def test_paged_decode_int8_plain_matches_jax(kw):
    """Kernel 7q's plain version against ``paged_decode_attention_ref`` on an
    int8 pool, and 0 for the all-trash row."""
    q, k, v, kpos, table, qpos = decode_case()
    kq, ks, vq, vs = quant_pool(k, v)
    jargs = tuple(jnp.asarray(a) for a in (q, kq, ks, vq, vs, kpos, table, qpos[:, None]))
    got = tk7.paged_decode_attention(t(q), t(kq), t(vq), t(kpos), t(table), t(qpos),
                                     k_scale=t(ks), v_scale=t(vs), **kw).numpy()
    ref = np.asarray(jk7.paged_decode_attention_ref(*jargs, **kw))
    np.testing.assert_allclose(got[:2], ref[:2], **TOL)
    assert np.all(got[2] == 0)
    assert tk7.launches == {"paged_decode_attention": 0, "paged_decode_attention_int8": 0}


@pytest.mark.parametrize("case,kw", [
    ("history", dict(scale=0.3)),
    ("history", dict(scale=0.3, window=4, softcap=5.0)),
    ("empty_pool", dict(scale=0.3)),
    ("recompute_overlap", dict(scale=0.3)),
], ids=["history", "window_softcap", "empty_pool_first_chunk", "recompute_overlap"])
def test_paged_prefill_int8_plain_matches_jax(case, kw):
    """Kernel 8q's plain version: an int8 pool before the chunk's write, the
    chunk's own K/V in f32, against ``paged_prefill_attention_ref``."""
    n_hist, start = {"history": (6, None), "empty_pool": (0, 0), "recompute_overlap": (6, 2)}[case]
    q, k, v, kpos, table, qpos, ck, cv = chunk_case(n_hist, start)
    kq, ks, vq, vs = quant_pool(k, v)
    jargs = tuple(jnp.asarray(a) for a in (q, kq, ks, vq, vs, kpos, table, qpos, ck, cv))
    got = tk8.paged_prefill_attention(t(q), t(kq), t(vq), t(kpos), t(table), t(qpos), t(ck), t(cv),
                                      k_scale=t(ks), v_scale=t(vs), **kw).numpy()
    ref = np.asarray(jk8.paged_prefill_attention_ref(*jargs, **kw))
    np.testing.assert_allclose(got, ref, **TOL)
    assert tk8.launches == {"paged_prefill_attention": 0, "paged_prefill_attention_int8": 0,
                            "paged_prefill_attention_batched": 0,
                            "paged_prefill_attention_batched_int8": 0}


# ---------------------------------------------------------------------------
# The paged ContinuousEngine with int8 experts and an int8 pool
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def load_quantized(name):
    jcfg = jax_make_reduced(jax_get_config(name)).replace(moe_impl="grouped")
    tcfg = make_reduced(get_config(name)).replace(moe_impl="grouped")
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, tcfg, jquantize_params(jparams, JQuantConfig(bits=8)),
            quantize_params(tparams, QuantConfig(bits=8)))


@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"])
def test_continuous_int8_greedy_tokens_identical(name):
    """Five prompts through 3 slots and a 10-page int8 pool: admission waits
    for pages, decode growth preempts, preempted requests re-prefill (chunk
    prefill over int8 pages, kernel 8q; decode, kernel 7q; int8 experts,
    kernel 5).  Tokens per request and the preemption count equal the JAX
    engine's, and the pool drains."""
    jcfg, tcfg, jqp, tqp = load_quantized(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, n).tolist() for n in (13, 6, 9, 3, 17)]
    kw = dict(slots=3, n_pages=10, capacity=32, paged=True, page_size=4, prefill_chunk=6,
              kv_cache_bits=8)
    out = []
    for eng, req in ((JaxEngine(jcfg, jqp, **kw), JaxRequest),
                     (ContinuousEngine(tcfg, tqp, device="cpu", **kw), Request)):
        ids = [eng.submit(req(prompt=p, max_new_tokens=7)) for p in prompts]
        done = eng.run_until_done()
        out.append(([done[i].tokens for i in ids], eng.preemptions))
    (jt, jp), (tt, tp) = out
    assert tt == jt and tp == jp >= 1
    assert eng.pool.free_count == eng.n_pages and not eng.queue
    assert isinstance(eng.caches["seg0"]["pos0"]["self"]["k"], tkv.QuantizedKV)
