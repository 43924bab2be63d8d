"""The split-K arithmetic of the paged attention kernels (kernel 7 splits a
row's live key tiles over several blocks whose f32 partials a second launch
merges), in plain PyTorch on the CPU: ``masked_partials`` over disjoint key
sets merged with ``merge_partials`` against the unsplit plain versions and
the JAX package's oracles, fp and int8 pools, and the split plan.

Tolerances: merged against unsplit, 1e-6 (f32, the same terms summed in
another order and rescaled once more); against the JAX ``_ref`` oracles, 1e-5
as in ``test_torch_paged.py``, on rows with a valid key (the oracles give a
row without one a uniform average, the kernels 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_paged as jk7
from repro.kernels import attention_prefill_paged as jk8
from repro_torch.kernels import attention_paged as tk7
from repro_torch.kernels import attention_prefill_paged as tk8
from repro_torch.quant.kv import kv_quantize_values

TOL = dict(atol=1e-5, rtol=1e-5)
MERGE_TOL = dict(atol=1e-6, rtol=1e-6)
KW = [dict(scale=0.3), dict(scale=0.3, window=9, softcap=5.0)]
KW_IDS = ["plain", "window_softcap"]
# P.V with the output in the scores' row layout [Hkv, G, C, dh], as the
# partials keep it (the plain prefill writes [C, Hkv, G, dh])
PREFILL_ROWS_PV = "hgct,thd->hgcd"


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def pool(rng, Pt, ps, Hkv, dh, int8):
    """K/V pool in f32, or int8 values with f32 scales [Pt, ps, Hkv, 1]
    quantized as the cache writes them; (k, v, scales dict) as numpy."""
    k = rng.standard_normal((Pt, ps, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((Pt, ps, Hkv, dh)).astype(np.float32)
    if not int8:
        return k, v, {}
    (kq, ks), (vq, vs) = kv_quantize_values(t(k)), kv_quantize_values(t(v))
    return kq.numpy(), vq.numpy(), dict(k_scale=ks.numpy(), v_scale=vs.numpy())


def decode_case(seed, int8):
    """4 slots over a 30-page pool (page 29 = trash), page size 4, with trash
    entries between live ones: 37 tokens, none (an all-trash row), one, 18."""
    rng = np.random.default_rng(seed)
    B, Hkv, G, dh, ps, nt, Pt = 4, 2, 3, 16, 4, 14, 30
    q = rng.standard_normal((B, Hkv, G, dh)).astype(np.float32)
    k, v, scales = pool(rng, Pt, ps, Hkv, dh, int8)
    kpos = np.full((Pt, ps), -1, np.int32)
    table = np.full((B, nt), Pt - 1, np.int32)
    free = list(rng.permutation(Pt - 1))
    for b, n in enumerate((37, 0, 1, 18)):
        pages = [free.pop() for _ in range(-(-n // ps))]
        slots = np.sort(rng.choice(nt, len(pages), replace=False))  # trash in between
        table[b, slots] = pages
        for p in range(n):
            kpos[pages[p // ps], p % ps] = p
    qpos = np.array([36, 0, 0, 17], np.int32)
    return (q, k, v, kpos, table, qpos), scales


def prefill_case(seed, int8):
    """A chunk of 7 queries at positions 21..27 over a row whose first 21
    positions sit in 6 pages of size 4 (the last half filled), one more page
    mapped but fresh, trash beyond."""
    rng = np.random.default_rng(seed)
    C, Hkv, G, dh, ps, Pt = 7, 2, 3, 16, 4, 20
    q = rng.standard_normal((C, Hkv, G, dh)).astype(np.float32)
    k, v, scales = pool(rng, Pt, ps, Hkv, dh, int8)
    ck = rng.standard_normal((C, Hkv, dh)).astype(np.float32)
    cv = rng.standard_normal((C, Hkv, dh)).astype(np.float32)
    kpos = np.full((Pt, ps), -1, np.int32)
    pages = list(rng.permutation(Pt - 1)[:7])
    for p in range(21):
        kpos[pages[p // ps], p % ps] = p
    table = np.array(pages + [Pt - 1] * 3, np.int32)
    qpos = np.arange(21, 28, dtype=np.int32)
    return (q, k, v, kpos, table, qpos, ck, cv), scales


def random_splits(rng, T, n_splits):
    """A random partition of the T keys into n_splits disjoint sets (some
    may be empty): the split id of each key."""
    return torch.from_numpy(rng.integers(0, n_splits, T))


def merged(s, kp, qp, v, pv, split_of, n_splits, kw):
    """masked_partials of each split (keys outside it at position -1),
    stacked split-first, merged."""
    parts = [tk7.masked_partials(s, torch.where(split_of == i, kp, -1), qp, v, pv,
                                 causal=kw.get("causal", True), window=kw.get("window", 0),
                                 softcap=kw.get("softcap", 0.0), scale=kw["scale"])
             for i in range(n_splits)]
    return tk7.merge_partials(*(torch.stack(x) for x in zip(*parts)))


def jax_args(arrs, scales):
    j = [jnp.asarray(a) for a in arrs]
    ks, vs = (jnp.asarray(scales[n]) if scales else None for n in ("k_scale", "v_scale"))
    return j, ks, vs


@pytest.mark.parametrize("kw", KW, ids=KW_IDS)
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("n_splits", [2, 5])
def test_decode_random_key_splits_merge_to_the_unsplit_result(n_splits, int8, kw):
    arrs, scales = decode_case(n_splits, int8)
    targs = [t(a) for a in arrs]
    tsc = {n: t(a) for n, a in scales.items()}
    s, kp, qp, v = tk7.decode_scores(*targs, **tsc)
    split_of = random_splits(np.random.default_rng(7), s.shape[-1], n_splits)
    got = merged(s, kp, qp, v, tk7.DECODE_PV, split_of, n_splits, kw)
    unsplit = tk7.paged_decode_attention_plain(*targs, **kw, **tsc)
    torch.testing.assert_close(got, unsplit, **MERGE_TOL)
    j, ks, vs = jax_args(arrs, scales)
    ref = np.asarray(jk7.paged_decode_attention_ref(j[0], j[1], ks, j[2], vs, j[3], j[4],
                                                    j[5][:, None], **kw))
    valid = [0, 2, 3]  # slot 1 is all trash
    np.testing.assert_allclose(got.numpy()[valid], ref[valid], **TOL)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("kw", KW, ids=KW_IDS)
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("n_splits", [2, 5])
def test_prefill_random_key_splits_merge_to_the_unsplit_result(n_splits, int8, kw):
    arrs, scales = prefill_case(n_splits, int8)
    targs = [t(a) for a in arrs]
    tsc = {n: t(a) for n, a in scales.items()}
    s, kp, qp, v = tk8.prefill_scores(*targs, **tsc)
    split_of = random_splits(np.random.default_rng(11), s.shape[-1], n_splits)
    got = merged(s, kp, qp, v, PREFILL_ROWS_PV, split_of, n_splits, kw).permute(2, 0, 1, 3)
    unsplit = tk8.paged_prefill_attention_plain(*targs, **kw, **tsc)
    torch.testing.assert_close(got, unsplit, **MERGE_TOL)
    j, ks, vs = jax_args(arrs, scales)
    ref = np.asarray(jk8.paged_prefill_attention_ref(j[0], j[1], ks, j[2], vs, *j[3:], **kw))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)  # every query sees itself


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_a_split_without_a_valid_key_leaves_the_merge_unchanged(which):
    if which == "decode":
        arrs, _ = decode_case(3, False)
        s, kp, qp, v = tk7.decode_scores(*(t(a) for a in arrs))
        pv = tk7.DECODE_PV
    else:
        arrs, _ = prefill_case(3, False)
        s, kp, qp, v = tk8.prefill_scores(*(t(a) for a in arrs))
        pv = PREFILL_ROWS_PV
    kw = dict(scale=0.3, causal=True, window=0, softcap=0.0)
    whole = tk7.masked_partials(s, kp, qp, v, pv, **kw)
    empty = tk7.masked_partials(s, torch.full_like(kp, -1), qp, v, pv, **kw)
    assert torch.all(empty[0] == tk7.NEG_INF) and torch.all(empty[1] == 0)
    assert torch.all(empty[2] == 0)
    one = tk7.merge_partials(*(x[None] for x in whole))
    two = tk7.merge_partials(*(torch.stack([a, b]) for a, b in zip(whole, empty)))
    assert torch.equal(one, two)


def test_a_row_without_a_valid_key_in_any_split_gives_zero():
    arrs, _ = decode_case(4, False)
    s, kp, qp, v = tk7.decode_scores(*(t(a) for a in arrs))
    split_of = random_splits(np.random.default_rng(1), s.shape[-1], 3)
    got = merged(s, kp, qp, v, tk7.DECODE_PV, split_of, 3, dict(scale=0.3))
    assert torch.isfinite(got).all()
    assert torch.all(got[1] == 0)  # slot 1: every entry trash
    assert not torch.all(got[0] == 0)


@pytest.mark.parametrize("ps", [4, 16])
def test_split_plan_takes_every_live_key_once(ps):
    """For every table width nt from 1 to 128, with trash entries anywhere:
    the live entries' keys, compacted into 64-key tiles, land in exactly one
    split under split_bounds, for the split counts decode_splits gives and
    for every count up to the number of tiles."""
    rng = np.random.default_rng(ps)
    for nt in range(1, 129):
        live = rng.random(nt) < rng.random()
        n_keys = int(live.sum()) * ps
        n_tiles = -(-n_keys // tk7.TILE_KEYS)
        counts = {tk7.decode_splits(nt, ps, B, Hkv, 132) for B, Hkv in ((1, 8), (8, 8), (64, 8))}
        counts |= set(range(1, max(n_tiles, 1) + 1))
        for n_splits in counts:
            assert 1 <= n_splits
            bounds = tk7.split_bounds(n_tiles, n_splits)
            taken = np.zeros(n_keys, np.int64)
            for lo, hi in bounds:
                assert 0 <= lo <= hi <= n_tiles
                taken[lo * tk7.TILE_KEYS:hi * tk7.TILE_KEYS] += 1
            assert np.all(taken == 1)


def test_decode_splits_fill_the_card_from_static_shapes():
    """About two blocks per SM at the served 8 slots x 8 kv-heads, never
    more splits than a row has 64-key tiles, at least one."""
    assert tk7.decode_splits(128, 16, 8, 8, 132) == 5
    assert tk7.decode_splits(1, 16, 8, 8, 132) == 1
    assert tk7.decode_splits(128, 16, 64, 8, 132) == 1
    assert tk7.decode_splits(128, 16, 1, 2, 132) == 32
