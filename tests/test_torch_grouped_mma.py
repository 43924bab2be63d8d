"""The tensor-core grouped expert MLP (kernels 4 and 5,
``csrc/grouped_mlp_mma.cu``) on the CPU: its run table's plain version
against the JAX package's grouped layout and on tile maps no dispatch
makes, the wrapper's static rules, the split down pass's contraction
ranges, and its order of quantized arithmetic (the column scale on the f32
sum) against the JAX package's oracle.

Tolerances: run tables, variants and plans are integers, compared exactly;
the split down pass's merged f32 partials agree with the whole f32 sum to
1e-5 relative. The quantized products: f32 activations and weights agree to 1e-5 (the
scale multiplies the sum instead of each weight, one more rounding per
output in f32); bf16 activations to 2e-2 of the largest output, the
kernels' bf16 tolerance on the card (``chip_smoke.py`` BF16_TOL), since the
JAX oracle rounds every dequantized weight to bf16 and the kernel does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch_grouped as jdg
from repro.core import gating as jgating
from repro.kernels import expert_mlp_grouped as jk
from repro.quant import qarrays as jq
from repro_torch.core import dispatch_grouped as tdg
from repro_torch.core import gating as tgating
from repro_torch.kernels import expert_mlp_grouped as tk
from repro_torch.quant import qarrays as tq

TILE = tdg.GROUPED_TILE


def routing(case, seed):
    """(logits [T, E] f32, K) of a named routing, from numpy."""
    rng = np.random.default_rng(seed)
    T, E, K = {"random": (40, 8, 1), "skewed": (64, 8, 1), "one_expert": (50, 8, 1),
               "empty_experts": (5, 16, 1), "one_token": (1, 8, 1), "top2": (30, 8, 2),
               "tile_edge": (16, 4, 1), "long_groups": (300, 4, 2)}[case]
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if case == "skewed":
        logits[:, 2] += 2.0  # most tokens on expert 2
    if case == "one_expert":
        logits[:, 5] += 100.0
    if case == "tile_edge":  # 8 tokens on each of experts 1 and 3: groups end on tile edges
        logits[:] = -10.0
        logits[:8, 1] = logits[8:, 3] = 10.0
    return logits, K


def jax_layout(logits, K):
    """The JAX package's grouped layout of this routing: (tile_expert,
    counts, rows_used = the padded groups' rows)."""
    T, E = logits.shape
    g = jgating.top_k_gating(jnp.asarray(logits), K, T * K)
    lay = jdg.grouped_layout(g, E)
    counts = np.asarray(lay.counts)
    rows_used = int(((counts + TILE - 1) // TILE * TILE).sum())
    return np.array(lay.tile_expert), counts, rows_used


CASES = ["random", "skewed", "one_expert", "empty_experts", "one_token", "top2", "tile_edge",
         "long_groups"]


@pytest.mark.parametrize("R", [1, 8, 16])
@pytest.mark.parametrize("case", CASES)
def test_run_table_plain_vs_jax_layout(case, R):
    """Every live tile of the JAX layout lies in exactly one run, in order;
    a run holds one expert's tiles, at most R, and starts at an expert's
    first tile or R tiles after the previous start; dead tiles (at or past
    rows_used, clamped to expert E-1) join no run; the count stays within
    the kernel's static bound ceil(nt / R) + E."""
    logits, K = routing(case, seed=CASES.index(case))
    T, E = logits.shape
    te, counts, rows_used = jax_layout(logits, K)
    nt = te.shape[0]
    # the port's layout is the JAX package's
    tl = tdg.grouped_layout(tgating.top_k_gating(torch.from_numpy(logits), K, T * K), E)
    np.testing.assert_array_equal(tl.tile_expert.numpy(), te)
    assert int(tl.rows_used) == rows_used

    used = torch.tensor([rows_used], dtype=torch.int32)
    table = tk.run_table_plain(torch.from_numpy(te.copy()), used, R)
    assert table.shape == (2 * nt + 2,)
    n = int(table[-1])
    starts = table[: n + 1].tolist()
    assert [b for _, b in tk.table_runs(table)] == starts[1:]  # a run ends where the next starts
    live = rows_used // TILE
    assert starts[0] == 0 and starts[-1] == live
    assert all(a < b for a, b in zip(starts, starts[1:]))  # every live tile once, in order
    assert n <= tk.max_runs(nt, E, R) <= -(-nt // R) + E
    for a, b in zip(starts, starts[1:]):
        assert b - a <= R
        assert len(set(te[a:b])) == 1  # one expert
        group_start = a
        while group_start > 0 and te[group_start - 1] == te[a]:
            group_start -= 1
        assert (a - group_start) % R == 0  # the run rule, exactly
    # the runs hold the routed groups: tiles per expert as the counts pad to
    tiles = np.zeros(E, np.int64)
    for a, b in zip(starts, starts[1:]):
        tiles[te[a]] += b - a
    np.testing.assert_array_equal(tiles, (counts + TILE - 1) // TILE)
    assert live <= nt and (live == nt or te[live:].max() == E - 1)  # dead tiles exist only past live


def test_run_table_empty_and_dead_tiles():
    """rows_used = 0 gives no run; tiles past rows_used never join a run
    even when they carry the last live expert's id."""
    te = torch.tensor([0, 0, 3, 3, 3, 3, 3], dtype=torch.int32)
    t = tk.run_table_plain(te, torch.tensor([0], dtype=torch.int32), 8)
    assert int(t[-1]) == 0 and int(t[0]) == 0
    t = tk.run_table_plain(te, torch.tensor([4 * TILE], dtype=torch.int32), 2)
    assert t[: int(t[-1]) + 1].tolist() == [0, 2, 4] and int(t[-1]) == 2


@pytest.mark.parametrize("nt,live,E,R,grid_rows", [
    (400, 400, 128, 8, 178),  # experts cycling: 400 runs of one tile
    (400, 400, 128, 16, 153),
    (400, 400, 128, 1, 400),  # runs of one tile: the grid has a row per tile
    (112, 20, 128, 1, 7),  # the decode buffer's grid (T*K <= 7 on it), 20 live tiles
    (112, 20, 128, 8, 7),
    (6, 6, 2, 8, 3),  # two experts, switching at every tile
    (2, 2, 10, 1, 1),  # a buffer shorter than the dispatch's for 10 experts
])
def test_run_table_takes_any_tile_map(nt, live, E, R, grid_rows):
    """A tile -> expert map no dispatch makes (experts cycling, so every
    tile is a run of its own; or a buffer shorter than the dispatch's) can
    hold more runs than the kernel's grid has rows (``max_runs``, which
    bounds the dispatch's buffers only): the table still holds every run in
    its 2 nt + 2 entries, each live tile once, and the grid's rows then take
    several runs each."""
    te = (torch.arange(nt) % min(3, E)).to(torch.int32)
    table = tk.run_table_plain(te, torch.tensor([live * TILE], dtype=torch.int32), R)
    assert table.shape == (2 * nt + 2,)
    n = int(table[-1])
    assert n == live and table[: n + 1].tolist() == list(range(live + 1))  # every tile its own run
    assert tk.table_runs(table) == [(j, j + 1) for j in range(live)]
    assert tk.max_runs(nt, E, R) == grid_rows
    assert (n > grid_rows) == (grid_rows < nt)


@pytest.mark.parametrize("T,K,E,bits,plan", [
    (4, 1, 128, 0, (1, 0, 3)),  # static decode: groups of one tile, the down pass split
    (1, 1, 128, 4, (1, 0, 4)),
    (4, 1, 128, 8, (1, 0, 3)),
    (8, 1, 128, 8, (1, 0, 3)),  # the continuous engine's 8 slots
    (8, 1, 128, 4, (1, 0, 4)),
    (16, 1, 128, 0, (1, 0, 1)),  # 23 grid rows: no split
    (256, 1, 128, 4, (1, 0, 1)),  # a 256-token prefill: about 2 tokens an expert
    (16384, 1, 128, 0, (16, 1, 1)),  # the long prefill, bf16: runs of 16
    (16384, 1, 128, 8, (8, 2, 1)),  # ... int8
    (64, 8, 32, 0, (8, 2, 1)),  # kimi-k2 width, top-8 over 32 experts
])
def test_mma_plan(T, K, E, bits, plan):
    nt = tdg.grouped_rows(T, K, E) // TILE
    assert tuple(tk.mma_plan(nt, E, bits)) == plan
    assert tk.max_runs(nt, E, plan[0]) >= 1
    if plan[2] > 1:  # the grid's rows bound the dispatch's runs: T*K of them at most
        assert T * K <= tk.max_runs(nt, E, 1) <= tk.SPLIT_RUNS


def split_sum(x, w, split):
    """x . w in f32 as the split down pass sums it: contraction stages of 32
    rows cut into ``split`` ranges [z nk / split, (z + 1) nk / split), each
    summed alone, the partials then added in the order of z."""
    nk = x.shape[-1] // 32
    parts = [x[:, z * nk // split * 32:(z + 1) * nk // split * 32] @ w[z * nk // split * 32:(z + 1) * nk // split * 32]
             for z in range(split)]
    out = torch.zeros_like(parts[0])
    for q in parts:
        out = out + q
    return out


@pytest.mark.parametrize("split", [1, 2, 3, 4, 6])
def test_split_ranges_cover_the_contraction_once(split):
    """Every 32-row stage lies in exactly one split's range, so the merged
    partials are the whole f32 sum (to f32 rounding: 1e-5 relative)."""
    K = 32 * 37  # a stage count no split divides
    nk = K // 32
    ranges = [(z * nk // split, (z + 1) * nk // split) for z in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == nk
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    g = torch.Generator().manual_seed(split)
    x, w = torch.randn(8, K, generator=g), torch.randn(K, 64, generator=g)
    torch.testing.assert_close(split_sum(x, w, split), x @ w, rtol=1e-5, atol=1e-5 * K ** 0.5)


def quant_inputs(seed, bits, dtype, E=4, D=32, F=64, T=24, K=2):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    g = tgating.top_k_gating(torch.from_numpy(logits), K, T * K)
    lay = tdg.grouped_layout(g, E)
    Ct = lay.tile_expert.shape[0] * TILE
    xg = np.zeros((Ct, D), np.float32)
    xg[lay.dst.numpy()] = rng.standard_normal((T * K, D)).astype(np.float32)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for n, s in (("wi", (E, D, F)), ("wg", (E, D, F)), ("wo", (E, F, D)))}
    if dtype == torch.bfloat16:  # bf16 values on both sides
        xg = torch.from_numpy(xg).bfloat16().float().numpy()
        w = {n: torch.from_numpy(v).bfloat16().float().numpy() for n, v in w.items()}
    return xg, lay, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_scale_on_sum_vs_jax_oracle(bits, dtype):
    """``grouped_mlp_quant_mma_plain`` ((x . q) * s, the tensor-core kernel's
    order) against ``grouped_mlp_quant_ref`` of the JAX package (x . (q * s)
    in the weights' type) on the same quantized weights."""
    xg, lay, w = quant_inputs(bits, bits, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jw = {n: jq.QuantizedArray.quantize(jnp.asarray(w[n], jdt), bits=bits) for n in w}
    tw = {n: tq.QuantizedArray.quantize(torch.from_numpy(w[n]).to(dtype), bits=bits) for n in w}
    for n in w:  # the same quantized values and scales on both sides
        np.testing.assert_array_equal(tw[n].q.numpy(), np.asarray(jw[n].q))
        np.testing.assert_array_equal(tw[n].scale.numpy(), np.asarray(jw[n].scale))
    ref = np.asarray(jk.grouped_mlp_quant_ref(jnp.asarray(xg, jdt), jnp.asarray(lay.tile_expert.numpy()),
                                              jw["wi"], jw["wg"], jw["wo"]).astype(jnp.float32))
    out = tk.grouped_mlp_quant_mma_plain(torch.from_numpy(xg).to(dtype), lay.tile_expert, tw["wi"],
                                         tw["wg"], tw["wo"], lay.rows_used).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
    dead = np.arange(out.shape[0]) >= int(lay.rows_used)
    assert (out[dead] == 0).all()


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU neither wrapper launches a kernel or counts a variant."""
    xg, lay, w = quant_inputs(0, 8, torch.bfloat16)
    for k in tk.variant_launches:
        tk.variant_launches[k] = 0
    x = torch.from_numpy(xg).bfloat16()
    ws = {n: torch.from_numpy(v).bfloat16() for n, v in w.items()}
    out = tk.grouped_mlp(x, lay.tile_expert, ws["wi"], ws["wg"], ws["wo"], lay.rows_used)
    torch.testing.assert_close(out, tk.grouped_mlp_plain(x, lay.tile_expert, ws["wi"], ws["wg"],
                                                         ws["wo"], lay.rows_used))
    qs = {n: tq.QuantizedArray.quantize(v, bits=4) for n, v in ws.items()}
    tk.grouped_mlp_quant(x, lay.tile_expert, qs["wi"], qs["wg"], qs["wo"], lay.rows_used)
    assert not any(tk.variant_launches.values())
    run_table = tk.run_table(lay.tile_expert, lay.rows_used, 8)
    torch.testing.assert_close(run_table, tk.run_table_plain(lay.tile_expert, lay.rows_used, 8))
