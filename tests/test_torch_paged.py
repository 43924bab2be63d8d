"""Port parity for the paged KV path: the port's copy of the block pool, the
plain versions of the paged decode and chunk-prefill kernels (kernels 7 and
8), the paged cache writes and the model-level paged entry points, against
the JAX package on the same inputs, in f32 on the CPU.

Tolerances: page bookkeeping and positions are exact; attention outputs,
written K/V and logits agree to 1e-5 (f32, the same products summed in
another order; the JAX kernels run in interpret mode).  The port's plain
versions compute the kernel's function, which gives a row with no valid key
0 (masked probabilities zeroed, as the TPU kernels do); the JAX ``_ref``
oracles give such a row a uniform average, so they are compared on the rows
that have a valid key.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.kernels import attention_paged as jk7
from repro.kernels import attention_prefill_paged as jk8
from repro.models import attention as jattn
from repro.models import model as jm
from repro.serving import kv_pool as jpool
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.kernels import attention_paged as tk7
from repro_torch.kernels import attention_prefill_paged as tk8
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.serving import kv_pool as tpool

TOL = dict(atol=1e-5, rtol=1e-5)
POOLS = pytest.mark.parametrize("pool_mod", [jpool, tpool], ids=["jax", "torch"])


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# Block pool and tables (the cases of test_paged.py, on both copies)
# ---------------------------------------------------------------------------


def test_pool_is_a_verbatim_copy():
    """Everything after the module docstring is the JAX package's code."""
    body = lambda m: inspect.getsource(m).split('"""', 2)[2]
    assert body(tpool) == body(jpool)


@POOLS
def test_pool_alloc_free_reuse(pool_mod):
    pool = pool_mod.KVBlockPool(4, 8)
    a = pool.alloc(3, owner=0)
    assert len(a) == 3 and pool.free_count == 1
    pool.free(a[:2])
    assert pool.free_count == 3
    b = pool.alloc(3, owner=1)
    assert len(b) == 3 and pool.free_count == 0
    assert len(set(b) | set(a[2:])) == 4  # recycled, not duplicated


@POOLS
def test_pool_alloc_all_or_nothing(pool_mod):
    pool = pool_mod.KVBlockPool(4, 8)
    assert pool.alloc(5, owner=0) is None
    assert pool.free_count == 4
    assert pool.alloc(4, owner=0) is not None


@POOLS
def test_pool_double_free_raises(pool_mod):
    pool = pool_mod.KVBlockPool(4, 8)
    a = pool.alloc(2, owner=0)
    pool.free(a)
    with pytest.raises(ValueError, match="double free"):
        pool.free(a[:1])


@POOLS
def test_pool_release_owner_is_preemption_safe(pool_mod):
    pool = pool_mod.KVBlockPool(8, 4)
    pool.alloc(3, owner=0)
    pool.alloc(2, owner=1)
    assert len(pool.release(0)) == 3
    assert pool.free_count == 6
    assert pool.release(0) == []
    assert pool.release(7) == []


@POOLS
def test_pool_accounting(pool_mod):
    pool = pool_mod.KVBlockPool(10, 16)
    assert [pool.pages_for(n) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]
    pool.alloc(5, owner=2)
    assert pool.used_count == 5 and pool.occupancy == 0.5


@POOLS
def test_tables_append_reset_overflow(pool_mod):
    bt = pool_mod.BlockTables(2, 4)
    bt.append(0, [7, 3])
    assert bt.n_mapped(0) == 2 and bt.n_mapped(1) == 0
    bt.append(0, [1])
    assert list(bt.row(0)[:3]) == [7, 3, 1]
    bt.reset(0)
    assert bt.n_mapped(0) == 0
    one = pool_mod.BlockTables(1, 2)
    one.append(0, [0, 1])
    with pytest.raises(ValueError, match="overflow"):
        one.append(0, [2])


# ---------------------------------------------------------------------------
# Kernels 7 and 8: the plain versions against the JAX kernels and oracles
# ---------------------------------------------------------------------------


def decode_case(seed=0):
    """3 slots over a 12-page pool (page 11 = trash), page size 4: slot 0
    spans 3 pages, slot 1 two, slot 2 none (an all-trash inactive row)."""
    rng = np.random.default_rng(seed)
    B, Hkv, G, dh, ps, nt, Pt = 3, 2, 2, 8, 4, 5, 12
    q = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    k = rng.standard_normal((Pt, ps, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((Pt, ps, Hkv, dh)).astype(np.float32)
    kpos = np.full((Pt, ps), -1, np.int32)
    table = np.full((B, nt), Pt - 1, np.int32)
    for b, (pages, n) in enumerate((([3, 7, 0], 10), ([5, 9], 6), ([], 0))):
        table[b, : len(pages)] = pages
        for p in range(n):
            kpos[pages[p // ps], p % ps] = p
    qpos = np.array([9, 5, 0], np.int32)
    return q, k, v, kpos, table, qpos


@pytest.mark.parametrize("kw", [dict(scale=0.35), dict(scale=0.35, window=3, softcap=5.0)],
                         ids=["plain", "window_softcap"])
def test_decode_plain_matches_jax(kw):
    q, k, v, kpos, table, qpos = decode_case()
    jargs = (jnp.asarray(q), jnp.asarray(k), None, jnp.asarray(v), None, jnp.asarray(kpos),
             jnp.asarray(table), jnp.asarray(qpos[:, None]))
    got = tk7.paged_decode_attention(t(q), t(k), t(v), t(kpos), t(table), t(qpos), **kw).numpy()
    kern = np.asarray(jk7.paged_decode_attention(*jargs, interpret=True, **kw))
    ref = np.asarray(jk7.paged_decode_attention_ref(*jargs, **kw))
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got[:2], ref[:2], **TOL)  # rows with a valid key
    assert np.all(got[2] == 0)  # the all-trash row: zero, finite
    assert tk7.launches["paged_decode_attention"] == 0  # CPU tensors take the plain version


def test_decode_trash_entries_contribute_nothing():
    """Widening a row's table with trash entries changes nothing."""
    q, k, v, kpos, table, qpos = decode_case(1)
    wide = np.concatenate([table, np.full((3, 4), k.shape[0] - 1, np.int32)], axis=1)
    a = tk7.paged_decode_attention_plain(t(q), t(k), t(v), t(kpos), t(table), t(qpos), scale=0.35)
    b = tk7.paged_decode_attention_plain(t(q), t(k), t(v), t(kpos), t(wide), t(qpos), scale=0.35)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def chunk_case(n_hist=6, start=None, seed=0):
    """A chunk of 5 queries over a row whose first n_hist positions sit in
    pages 3 and 7; page 1 is mapped but fresh, the last entry unmapped."""
    rng = np.random.default_rng(seed)
    C, Hkv, G, dh, ps, Pt = 5, 2, 2, 8, 4, 10
    q = rng.standard_normal((C, Hkv, G, dh)).astype(np.float32)
    k = rng.standard_normal((Pt, ps, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((Pt, ps, Hkv, dh)).astype(np.float32)
    ck = rng.standard_normal((C, Hkv, dh)).astype(np.float32)
    cv = rng.standard_normal((C, Hkv, dh)).astype(np.float32)
    kpos = np.full((Pt, ps), -1, np.int32)
    for p in range(n_hist):
        kpos[[3, 7][p // ps], p % ps] = p
    table = np.array([3, 7, 1, Pt - 1], np.int32)
    start = n_hist if start is None else start
    qpos = np.arange(start, start + C, dtype=np.int32)
    return q, k, v, kpos, table, qpos, ck, cv


@pytest.mark.parametrize("case,kw", [
    ("history", dict(scale=0.3)),
    ("history", dict(scale=0.3, window=4, softcap=5.0)),
    ("empty_pool", dict(scale=0.3)),
    ("recompute_overlap", dict(scale=0.3)),
], ids=["history", "window_softcap", "empty_pool_first_chunk", "recompute_overlap"])
def test_prefill_plain_matches_jax(case, kw):
    """The empty pool is a first chunk (every page tile fully masked); the
    overlap case starts the chunk at position 2 while the pool holds 0..5,
    so pool keys at positions >= 2 must be masked."""
    n_hist, start = {"history": (6, None), "empty_pool": (0, 0), "recompute_overlap": (6, 2)}[case]
    q, k, v, kpos, table, qpos, ck, cv = chunk_case(n_hist, start)
    arrs = (q, k, v, kpos, table, qpos, ck, cv)
    j = [jnp.asarray(a) for a in arrs]
    jargs = (j[0], j[1], None, j[2], None, *j[3:])
    got = tk8.paged_prefill_attention(*(t(a) for a in arrs), **kw).numpy()
    kern = np.asarray(jk8.paged_prefill_attention(*jargs, interpret=True, **kw))
    ref = np.asarray(jk8.paged_prefill_attention_ref(*jargs, **kw))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)  # every query sees at least itself
    assert tk8.launches["paged_prefill_attention"] == 0


# ---------------------------------------------------------------------------
# Paged cache writes and model-level entry points
# ---------------------------------------------------------------------------


def test_chunk_write_routes_already_written_positions_to_trash():
    """A chunk whose positions a page already holds (a shared prefix page)
    leaves that page untouched and writes the trash page with pos -1."""
    _, k, v, kpos, table, _, _, _ = chunk_case(6)
    rng = np.random.default_rng(3)
    kn = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    positions = np.arange(4, 8, dtype=np.int32)  # 4, 5 already in page 7; 6, 7 fresh
    jc = jattn._paged_cache_write_chunk(
        {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(kpos)},
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(positions), jnp.asarray(table))
    tc = tattn._paged_cache_write_chunk({"k": t(k), "v": t(v), "pos": t(kpos)}, t(kn), t(vn),
                                        t(positions), t(table))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["k"].numpy()[:-1], np.asarray(jc["k"])[:-1])
    np.testing.assert_array_equal(tc["v"].numpy()[:-1], np.asarray(jc["v"])[:-1])
    np.testing.assert_array_equal(tc["k"].numpy()[7, :2], k[7, :2])  # the held entries


@pytest.fixture(scope="module")
def pair():
    name = "llama4-maverick-400b-a17b"
    jcfg = jax_make_reduced(jax_get_config(name)).replace(moe_impl="grouped")
    tcfg = make_reduced(get_config(name)).replace(moe_impl="grouped")
    jparams = jax.jit(lambda key: jm.init_params(jcfg, key))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def assert_pools_equal(tc, jc):
    """k, v and pos of every layer's pool; the trash page's K/V are whatever
    inactive rows wrote there, its positions must stay -1."""
    for sk in tc:
        for pk in tc[sk]:
            a, b = tc[sk][pk]["self"], jc[sk][pk]["self"]
            np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(b["pos"]))
            assert (a["pos"].numpy()[:, -1] == -1).all()
            for key in ("k", "v"):
                np.testing.assert_allclose(a[key].numpy()[:, :-1], np.asarray(b[key])[:, :-1], **TOL)


def test_model_paged_prefill_decode_reset(pair):
    """Three prompts prefilled chunk by chunk (4 tokens, page size 4) into a
    shared pool, one batched decode tick with an inactive middle row, then
    the pages of slot 0 released and reset: the logits and the pool's k, v
    and pos after every call equal the JAX functions'."""
    jcfg, tcfg, jparams, tparams = pair
    cap, ps, n_pages, slots = 32, 4, 12, 3
    jc = jm.init_paged_caches(jcfg, slots, cap, n_pages=n_pages, page_size=ps)
    tc = tm.init_paged_caches(tcfg, slots, cap, n_pages=n_pages, page_size=ps, device="cpu")
    pool = tpool.KVBlockPool(n_pages, ps)
    tables = tpool.BlockTables(slots, cap // ps)
    jchunk = jax.jit(lambda p, tok, pos, s, c, row, reset: jm.paged_prefill_chunk(
        jcfg, p, tok, pos, s, c, row, capacity=cap, page_size=ps, reset=reset),
        static_argnames="reset")
    rng = np.random.default_rng(0)
    lens = (7, 10, 3)
    for i, n in enumerate(lens):
        prompt = rng.integers(1, jcfg.vocab_size, n).astype(np.int32)
        tables.append(i, pool.alloc(pool.pages_for(n), owner=i))
        row = tables.row(i).copy()
        for s0 in range(0, n, 4):
            toks, pos = prompt[None, s0 : s0 + 4], np.arange(s0, min(n, s0 + 4), dtype=np.int32)[None]
            jl, jc = jchunk(jparams, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(i, jnp.int32),
                            jc, jnp.asarray(row), s0 == 0)
            tl, tc = tm.paged_prefill_chunk(tcfg, tparams, t(toks).long(), t(pos), tc, t(row))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_pools_equal(tc, jc)

    for i, n in enumerate(lens):  # map the decode write position
        if tables.n_mapped(i) <= n // ps:
            tables.append(i, pool.alloc(1, owner=i))
    active = np.array([True, False, True])
    tbl = np.where(active[:, None], tables.table, -1).astype(np.int32)
    toks = np.array([[5], [6], [7]], np.int32)
    positions = np.array(lens, np.int32)
    jdecode = jax.jit(lambda p, tok, pos, act, c, tb: jm.paged_ragged_decode_step(
        jcfg, p, tok, pos, act, c, tb))
    jl, jc = jdecode(jparams, jnp.asarray(toks), jnp.asarray(positions), jnp.asarray(active), jc,
                     jnp.asarray(tbl))
    tl, tc = tm.paged_ragged_decode_step(tcfg, tparams, t(toks).long(), t(positions), tc, t(tbl))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active], **TOL)
    assert_pools_equal(tc, jc)

    mask = np.zeros(n_pages + 1, bool)
    mask[pool.release(0)] = True
    jc = jax.jit(lambda c, m: jm.paged_reset_pages(jcfg, c, m))(jc, jnp.asarray(mask))
    tc = tm.paged_reset_pages(tcfg, tc, t(mask))
    assert_pools_equal(tc, jc)
    assert (tc["seg0"]["pos0"]["self"]["pos"].numpy()[:, mask] == -1).all()
