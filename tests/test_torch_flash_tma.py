"""Host-side arithmetic of kernel 6's wgmma path (bf16, head dims 64, 128
and 256), on the CPU: the query-tile height, the K/V tile size, the TMA
tensor-map arguments and
their alignment checks, and the tile marks that decide which K/V tiles a
block loads and which it masks per entry, in plain PyTorch, from a short
row's positions and from a long row's tile summaries: live tiles are those
holding a key some row may see (exactly from positions; at worst also a
tile whose keys straddle the rows' range, from summaries), full tiles
exactly those every row sees whole, and attention over the live tiles
alone equals attention over every key (exact: a skipped tile contributes
0).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.attention_paged import tile_marks


def test_routing_by_head_dim_and_query_tile_height():
    assert set(fa.WGMMA_HEAD_DIMS) == {64, 128, 256} and set(fa.WGMMA_HEAD_DIMS) < set(fa.HEAD_DIMS)
    assert fa.q_tile_rows(64, 40, 4, 132) == 64  # the served 4 x 64 prefill: one warpgroup
    assert fa.q_tile_rows(1, 16, 4, 132) == 64
    assert fa.q_tile_rows(65, 40, 4, 132) == 128  # 2 x 40 x 4 blocks
    assert fa.q_tile_rows(16384, 40, 1, 132) == 128
    assert fa.q_tile_rows(128, 40, 1, 132) == 64  # 40 blocks of 128 rows: 80 of 64
    assert fa.q_tile_rows(4096, 16, 1, 132) == 128
    # head dim 256 (recurrentgemma-2b, 10 heads): 128-row blocks at every S
    for S, B in ((4096, 1), (1500, 4), (300, 3), (40, 3), (1, 1)):
        assert fa.q_tile_rows(S, 10, B, 132, dh=256) == 128


def test_key_tile_follows_the_query_tile_and_head_dim():
    """``WgCfg::BN``: 128 keys under 128-row blocks, 64 under 64-row blocks
    and at head dim 256, whose two stages of K and V then take 128 KB
    beside the 64 KB query tile."""
    assert fa.kv_tile_keys(64, 128) == fa.kv_tile_keys(128, 128) == fa.KEY_TILE
    assert fa.kv_tile_keys(64, 64) == fa.kv_tile_keys(128, 64) == 64
    assert fa.kv_tile_keys(256, 128) == 64
    q_bytes = 128 * 256 * 2
    kv_bytes = 2 * 2 * fa.kv_tile_keys(256, 128) * 256 * 2  # K and V, two stages
    assert q_bytes + kv_bytes == 192 * 1024 < 227 * 1024
    assert q_bytes + 2 * 2 * 128 * 256 * 2 > 227 * 1024  # 128-key tiles would not fit


def test_tensor_map_arguments_follow_the_model_layouts():
    """q [B, S, H, dh] and k / v [B, T, Hkv, dh] read in place as 4-D
    maps: dims innermost first, byte strides of the outer three, boxes of
    64 columns (128 bytes: a dh = 128 row is two boxes)."""
    dims, strides, box = fa.tensor_map_args((1, 16384, 40, 128), 128)
    assert dims == (128, 40, 16384, 1)
    assert strides == (256, 40 * 256, 16384 * 40 * 256)
    assert box == (64, 1, 128, 1)
    dims, strides, box = fa.tensor_map_args((4, 80, 16, 64), 64)
    assert dims == (64, 16, 80, 4) and strides == (128, 2048, 80 * 2048) and box == (64, 1, 64, 1)
    assert box[0] * 2 == 128  # the swizzle span


def test_tensor_map_arguments_at_head_dim_256():
    """recurrentgemma-2b's q [1, 4096, 10, 256] and k [1, 4096, 1, 256]: a
    row is four 64-column boxes (512 bytes), q's box 128 rows, K/V's 64
    keys (``kv_tile_keys``)."""
    dims, strides, box = fa.tensor_map_args((1, 4096, 10, 256), fa.q_tile_rows(4096, 10, 1, 132, 256))
    assert dims == (256, 10, 4096, 1)
    assert strides == (512, 10 * 512, 4096 * 10 * 512)
    assert box == (64, 1, 128, 1) and dims[0] // box[0] == 4
    dims, strides, box = fa.tensor_map_args((4, 1500, 1, 256), fa.kv_tile_keys(256, 128))
    assert dims == (256, 1, 1500, 4) and strides == (512, 512, 1500 * 512)
    assert box == (64, 1, 64, 1) and dims[0] // box[0] == 4


def test_tma_checks_raise_on_misaligned_bases_and_strides():
    x = torch.zeros(2 * 3 * 4 * 64 + 8, dtype=torch.bfloat16)
    fa.check_tma("fa", q=x[:2 * 3 * 4 * 64].view(2, 3, 4, 64))  # a fresh allocation: aligned
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa.check_tma("fa", k=x[1:1 + 2 * 3 * 4 * 64].view(2, 3, 4, 64))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.check_tma("fa", v=torch.zeros(2, 3, 4, 4, dtype=torch.bfloat16))
    pos = torch.zeros(3 * 5 + 1, dtype=torch.int32)
    fa.check_tma("fa", k_pos=pos[:15].view(3, 5))  # a 1-D map: any row length
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa.check_tma("fa", k_pos=pos[1:].view(3, 5))


def _positions(seed):
    """Two batch rows of 700 slots: row 0 a prefix of 600 positions with
    holes, row 1 a ring of positions 1000-1699 wrapping at slot 250 with an
    empty stretch."""
    rng = np.random.default_rng(seed)
    kp = np.full((2, 700), -1, np.int32)
    kp[0, :600] = np.arange(600)
    kp[0, rng.random(700) < 0.1] = -1
    kp[1] = np.roll(np.arange(1000, 1700), 250)
    kp[1, 400:560] = -1
    return torch.from_numpy(kp)


@pytest.mark.parametrize("tile", [64, 128])
def test_summaries_are_min_max_count_of_valid_positions(tile):
    kp = _positions(0)
    summ = fa.tile_summaries(kp, tile)
    n = -(-700 // tile)
    assert summ.shape == (2, n, 3)
    for b in range(2):
        for j in range(n):
            keys = kp[b, j * tile:(j + 1) * tile]
            keys = keys[keys >= 0]
            if keys.numel():
                assert summ[b, j].tolist() == [keys.min().item(), keys.max().item(), keys.numel()]
            else:
                assert summ[b, j, 2] == 0


@pytest.mark.parametrize("window", [0, 150])
@pytest.mark.parametrize("q_range", [(0, 127), (300, 427), (1500, 1627), (1600, 1699), (1299, 1299)])
def test_summary_marks_skip_no_visible_key_and_mark_full_tiles_exactly(q_range, window):
    """A long row's marks: a tile some row may see is never skipped (a tile
    whose keys straddle the range may be loaded and masked), full is exact
    and agrees with the marks from positions."""
    kp = _positions(1)
    q_lo, q_hi = q_range
    for b in range(2):
        live, full = fa.summary_marks(fa.tile_summaries(kp[b:b + 1])[0], q_lo, q_hi, window=window)
        exact_live, exact_full = tile_marks(kp[b], q_lo, q_hi, tile=fa.KEY_TILE, window=window)
        assert bool((live | ~exact_live).all()), b
        assert torch.equal(full, exact_full), b


@pytest.mark.parametrize("tile", [64, 128])
def test_marks_take_keys_past_the_row_as_invalid(tile):
    """A row whose length is not a multiple of the tile: its last tile is
    live only for its own keys and never full, even where every key it has
    is valid."""
    T = 3 * tile - 5
    kp = torch.arange(T, dtype=torch.int32)
    live, full = tile_marks(kp, T + 10, T + 10, tile=tile)
    assert live.tolist() == [True, True, True] and full.tolist() == [True, True, False]
    kp[2 * tile:] = -1
    live, full = tile_marks(kp, T + 10, T + 10, tile=tile)
    assert live.tolist() == [True, True, False] and full.tolist() == [True, True, False]


@pytest.mark.parametrize("tile", [64, 128])  # kernel 9's tiles, kernel 6's
@pytest.mark.parametrize("window", [0, 150])
@pytest.mark.parametrize("q_range", [(0, 127), (300, 427), (1500, 1627), (1600, 1699), (1299, 1299)])
def test_marks_skip_no_visible_key_and_mark_full_tiles_exactly(q_range, window, tile):
    kp = _positions(1)
    q_lo, q_hi = q_range
    for b in range(2):
        live, full = tile_marks(kp[b], q_lo, q_hi, tile=tile, window=window)
        for j in range(live.numel()):
            keys = torch.full((tile,), -1, dtype=torch.int32)
            chunk = kp[b, j * tile:(j + 1) * tile]
            keys[:chunk.numel()] = chunk
            qs = torch.arange(q_lo, q_hi + 1)[:, None]
            seen = (keys >= 0) & (keys <= qs)
            if window:
                seen &= qs - keys < window
            assert bool(live[j]) == bool(seen.any()), (b, j)  # skipped: no row sees a key
            assert bool(full[j]) == bool(seen.all()), (b, j)


def test_attention_over_live_tiles_alone_equals_attention_over_every_key():
    """Skipping the tiles the marks leave out changes nothing: the plain
    version over the live tiles' keys only against over all keys."""
    torch.manual_seed(0)
    kp = _positions(2)
    B, T, S, H, Hkv, dh, tile = 2, 700, 128, 4, 2, 64, fa.KEY_TILE
    q = torch.randn(B, S, H, dh)
    k, v = torch.randn(B, T, Hkv, dh), torch.randn(B, T, Hkv, dh)
    q_pos = torch.stack([torch.arange(300, 300 + S), torch.arange(1500, 1500 + S)]).to(torch.int32)
    kw = dict(scale=0.125, causal=True, window=150)
    want = fa.flash_attention_plain(q, k, v, q_pos, kp, **kw)
    kept = kp.clone()
    for b in range(B):
        live, _ = tile_marks(kp[b], int(q_pos[b].min()), int(q_pos[b].max()), tile=tile,
                             window=150)
        dead = (~live).repeat_interleave(tile)[:T]
        kept[b, dead] = -1
    got = fa.flash_attention_plain(q, k, v, q_pos, kept, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 150])
@pytest.mark.parametrize("q_range", [(0, 127), (300, 427), (1500, 1627), (1600, 1699), (1299, 1299)])
def test_64_key_tiles_marked_from_128_key_summaries(q_range, window):
    """Head dim 256's 64-key tiles take their 128-key summary's marks
    (``kv_tile_marks``): no tile holding a key some row sees is skipped,
    and a tile marked full is full."""
    kp = _positions(1)
    q_lo, q_hi = q_range
    for b in range(2):
        summ = fa.tile_summaries(kp[b:b + 1])[0]
        live, full = fa.kv_tile_marks(summ, q_lo, q_hi, -(-700 // 64), tile=64, window=window)
        exact_live, exact_full = tile_marks(kp[b], q_lo, q_hi, tile=64, window=window)
        assert live.shape == exact_live.shape == (11,)
        assert bool((live | ~exact_live).all()), b
        assert bool((exact_full | ~full).all()), b
    # 128-key tiles take their own summary: the marks are summary_marks'
    summ = fa.tile_summaries(kp[:1])[0]
    assert all(torch.equal(x, y) for x, y in zip(
        fa.kv_tile_marks(summ, q_lo, q_hi, summ.shape[0], tile=128, window=window),
        fa.summary_marks(summ, q_lo, q_hi, window=window)))


def test_attention_over_64_key_tiles_from_summaries_equals_attention_over_every_key():
    """At head dim 256, skipping the 64-key tiles their summaries leave
    out changes nothing."""
    torch.manual_seed(1)
    kp = _positions(3)
    B, T, S, H, Hkv, dh = 2, 700, 128, 10, 1, 256
    q = torch.randn(B, S, H, dh)
    k, v = torch.randn(B, T, Hkv, dh), torch.randn(B, T, Hkv, dh)
    q_pos = torch.stack([torch.arange(300, 300 + S), torch.arange(1500, 1500 + S)]).to(torch.int32)
    kw = dict(scale=dh ** -0.5, causal=True, window=150)
    want = fa.flash_attention_plain(q, k, v, q_pos, kp, **kw)
    kept = kp.clone()
    for b in range(B):
        summ = fa.tile_summaries(kp[b:b + 1])[0]
        live, _ = fa.kv_tile_marks(summ, int(q_pos[b].min()), int(q_pos[b].max()), -(-T // 64),
                                   tile=64, window=150)
        kept[b, (~live).repeat_interleave(64)[:T]] = -1
    got = fa.flash_attention_plain(q, k, v, q_pos, kept, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
