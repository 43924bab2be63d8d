"""The split-K arithmetic of kernel 9 (int8 decode attention over a
contiguous cache: the bf16 kernel splits each row's live 64-key tiles over
several blocks whose f32 partials a later launch merges), in plain PyTorch
on the CPU: random key splits and the kernel's own plan by tile rank, merged
with ``merge_partials``, against the unsplit plain version and the JAX
package's ``decode_attention_quant_ref``; and the plan itself (live tiles
from positions only, windows of 256 tiles, static split counts).

Tolerances: merged against unsplit, 1e-6 (f32, the same terms summed in
another order and rescaled once more); against the JAX oracle, 1e-5 as in
``test_torch_kv_quant.py``, on rows with a valid key (the oracle gives a row
without one a uniform average, the kernel 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_quant as jk9
from repro.quant import kv as jkv
from repro_torch.kernels import attention_paged as tk7
from repro_torch.kernels import attention_quant as tk9

TOL = dict(atol=1e-5, rtol=1e-5)
MERGE_TOL = dict(atol=1e-6, rtol=1e-6)
KW = [dict(scale=0.3), dict(scale=0.3, window=40, softcap=5.0)]
KW_IDS = ["plain", "window_softcap"]
T = 200  # not a multiple of 64: the last tile is ragged
EMPTY_ROW = 1


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def case(seed, G):
    """4 rows over a contiguous int8 cache of T = 200 slots, 2 kv-heads, G
    query heads each, quantized by the JAX quantizer: row 0 a prefix of 150
    positions, row 1 empty (no valid key), row 2 a ring whose positions
    300-499 wrap at slot 77, row 3 only its first 8 slots filled (most of its
    tiles empty).  Returns numpy (q, kq, ks, vq, vs, kpos, qpos)."""
    rng = np.random.default_rng(seed)
    B, Hkv, dh = 4, 2, 16
    q = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, dh)).astype(np.float32) for _ in range(2))
    kq, ks = (np.asarray(a) for a in jkv.kv_quantize_values(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jkv.kv_quantize_values(jnp.asarray(v)))
    kpos = np.full((B, T), -1, np.int32)
    kpos[0, :150] = np.arange(150)
    kpos[2] = np.roll(np.arange(300, 500), 77)
    kpos[3, :8] = np.arange(8)
    qpos = np.array([149, 0, 499, 7], np.int32)
    return q, kq, ks, vq, vs, kpos, qpos


def jax_ref(arrs, kw):
    q, kq, ks, vq, vs, kpos, qpos = (jnp.asarray(a) for a in arrs)
    return np.asarray(jk9.decode_attention_quant_ref(q, kq, ks, vq, vs, kpos, qpos[:, None], **kw))


def check_rows(got, arrs, kw):
    """Merged against unsplit (1e-6) and the JAX oracle (1e-5, rows with a
    valid key); the empty row exactly 0."""
    targs = [t(a) for a in arrs]
    unsplit = tk9.decode_attention_quant_plain(*targs, **kw)
    torch.testing.assert_close(got, unsplit, **MERGE_TOL)
    ref = jax_ref(arrs, kw)
    valid = [b for b in range(got.shape[0]) if b != EMPTY_ROW]
    np.testing.assert_allclose(got.numpy()[valid], ref[valid], **TOL)
    assert torch.all(got[EMPTY_ROW] == 0)


@pytest.mark.parametrize("kw", KW, ids=KW_IDS)
@pytest.mark.parametrize("G", [1, 3, 16])
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_kernel_split_plan_merges_to_the_unsplit_result(splits, G, kw):
    """The kernel's own plan (``split_tiles``: each window's live tiles by
    rank), at split counts up to more than a row's live tiles (empty
    splits), G = 1, 3 and 16."""
    arrs = case(10 * splits + G, G)
    got = tk9.decode_attention_quant_split(*(t(a) for a in arrs), splits, **kw)
    check_rows(got, arrs, kw)


@pytest.mark.parametrize("kw", KW, ids=KW_IDS)
@pytest.mark.parametrize("n_splits", [2, 4])
def test_random_key_splits_merge_to_the_unsplit_result(n_splits, kw):
    """Any partition of the keys merges to the same result: each key goes
    to a random split, some splits empty for some rows."""
    arrs = case(n_splits, 5)
    q, kq, ks, vq, vs, kpos, qpos = (t(a) for a in arrs)
    B, Hkv, G, dh = q.shape
    k = tk7.kv_values(kq, ks, q.dtype)
    v = tk7.kv_values(vq, vs, q.dtype)
    s = torch.einsum("bhgd,bthd->bhgt", q, k)
    split_of = torch.from_numpy(np.random.default_rng(3).integers(0, n_splits, (B, T)))
    parts = [tk7.masked_partials(s, torch.where(split_of == i, kpos, -1).reshape(B, 1, 1, T),
                                 qpos.reshape(B, 1, 1, 1), v, tk7.DECODE_PV,
                                 causal=True, window=kw.get("window", 0),
                                 softcap=kw.get("softcap", 0.0), scale=kw["scale"])
             for i in range(n_splits)]
    got = tk7.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    check_rows(got, arrs, kw)


def test_a_row_without_a_valid_key_in_any_split_gives_zero():
    arrs = case(1, 4)
    arrs[5][0] = -1  # row 0 emptied as well
    got = tk9.decode_attention_quant_split(*(t(a) for a in arrs), 3, scale=0.3)
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0) and torch.all(got[EMPTY_ROW] == 0)
    assert not torch.all(got[2] == 0)


@pytest.mark.parametrize("window", [0, 40])
def test_live_tiles_come_from_positions_not_slots(window):
    """A ring's live slots wrap: the tiles that hold a key valid for the
    query are found from its positions, exactly, and a mostly empty row
    reads only the tiles it fills."""
    kpos = np.roll(np.arange(300, 500), 77).astype(np.int32)  # slot 77 holds 300
    live = tk9.live_tiles(kpos, 499, window=window)
    valid = (kpos >= 0) & (kpos <= 499) & ((499 - kpos < window) if window else True)
    assert live == sorted({i // tk7.TILE_KEYS for i in np.nonzero(valid)[0]})
    if window:  # positions 460-499 sit in slots 37-76: tiles 0 and 1; tiles 2, 3 hold 423 on
        assert live == [0, 1]
    sparse = np.full(16392, -1, np.int32)
    sparse[:8] = np.arange(8)
    assert tk9.live_tiles(sparse, 7) == [0]
    assert tk9.live_tiles(np.full(100, -1, np.int32), 5) == []
    future = np.arange(200, dtype=np.int32)
    assert tk9.live_tiles(future, 63) == [0]  # causal: keys past the query are dead


def test_split_plan_takes_every_live_tile_once_per_window():
    """Rows of up to three windows of 256 tiles with random holes: every
    live tile lands in exactly one split, no dead tile in any, and within a
    window the splits take consecutive ranks."""
    rng = np.random.default_rng(0)
    for n_keys in (1, 63, 64, 200, 16392, 40000):
        kpos = np.arange(n_keys, dtype=np.int32)
        kpos[rng.random(n_keys) < 0.5 * rng.random()] = -1
        holes = rng.integers(0, max(1, n_keys // 64), 5)
        for h in holes:
            kpos[h * 64:(h + 1) * 64] = -1  # whole tiles empty
        qpos = n_keys - 1
        live = tk9.live_tiles(kpos, qpos)
        for splits in (1, 2, 7, 33):
            plan = tk9.split_tiles(kpos, qpos, splits)
            taken = sorted(j for share in plan for j in share)
            assert taken == live
            for share in plan:
                for w in {j // tk9.WINDOW_TILES for j in share}:
                    ranks = [live.index(j) for j in share if j // tk9.WINDOW_TILES == w]
                    assert ranks == list(range(ranks[0], ranks[0] + len(ranks)))


def test_split_count_comes_from_static_shapes():
    """``decode_splits`` over the row's ceil(T / 64) tiles, as the wrapper
    calls it: about two blocks per SM, never more splits than tiles."""
    assert tk7.decode_splits(80, 1, 4, 8, 132) == 2  # the served 4 x 80 cache
    assert tk7.decode_splits(2048, 1, 8, 8, 132) == 5  # 8 x 2048
    assert tk7.decode_splits(16392, 1, 1, 8, 132) == 33
    assert tk7.decode_splits(64, 1, 1, 1, 132) == 1


def test_split_count_at_head_dim_256_is_one_wave():
    """At dh 256 (its kernel of its own) ``decode_splits`` takes one wave of
    one block per SM over the B * Hkv rows, never more splits than tiles and
    at least one: 16 at recurrentgemma's 8 x 2048 ring (2 tiles a split)."""
    assert tk7.decode_splits(2048, 1, 8, 1, 132, dh=256) == 16
    assert tk7.decode_splits(2048, 1, 1, 1, 132, dh=256) == 32  # one row: a tile a split
    assert tk7.decode_splits(300, 1, 3, 1, 132, dh=256) == 5
    assert tk7.decode_splits(2048, 1, 200, 1, 132, dh=256) == 1
    # the merge's reach: a long single row takes at most MAX_SPLITS_DH256
    assert tk7.decode_splits(16392, 1, 1, 1, 132, dh=256) == tk7.MAX_SPLITS_DH256 == 32
    for B in range(1, 140):
        n = tk7.decode_splits(2048, 1, B, 1, 132, dh=256)
        assert 1 <= n <= 32 and (B * n <= 132 or n == 1)
    assert tk7.decode_splits(2048, 1, 8, 8, 132) == 5  # other head dims as before


@pytest.mark.parametrize("kw", KW, ids=KW_IDS)
def test_split_plan_at_head_dim_256_merges_to_the_unsplit_result(kw):
    """recurrentgemma's heads (10 over 1, dh 256) over a ring of 200 slots
    that wraps at slot 77, an empty row and a mostly empty one, split as
    the wrapper splits a row at dh 256 (``decode_splits``), against the
    unsplit plain version and the JAX oracle."""
    rng = np.random.default_rng(256)
    B, Hkv, G, dh = 4, 1, 10, 256
    q = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, Hkv, dh)).astype(np.float32) for _ in range(2))
    kq, ks = (np.asarray(a) for a in jkv.kv_quantize_values(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jkv.kv_quantize_values(jnp.asarray(v)))
    kpos = np.full((B, T), -1, np.int32)
    kpos[0, :150] = np.arange(150)
    kpos[2] = np.roll(np.arange(300, 500), 77)
    kpos[3, :8] = np.arange(8)
    arrs = (q, kq, ks, vq, vs, kpos, np.array([149, 0, 499, 7], np.int32))
    splits = tk7.decode_splits(T, 1, B, Hkv, 132, dh=dh)
    assert splits == 4  # ceil(200 / 64) tiles, under 132 // 4 = 33
    got = tk9.decode_attention_quant_split(*(t(a) for a in arrs), splits, **kw)
    check_rows(got, arrs, kw)
