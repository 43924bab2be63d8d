"""Kernel 3 on the tensor cores (the capacity layout of
``csrc/grouped_mlp_mma.cu``) and kernel 1's one-launch rank scan
(``csrc/moe_gating.cu``), on the CPU: the capacity run table's plain version
on dead, empty, overflowing and deep buffers and on any fill, the grid's
bound against the run count, the plan rule, the kernel's order of quantized
arithmetic against the JAX package's kernel and oracle, the rank scan's
order (chunks of a rank block's width, warps of 32, a carry per expert) against
``top_k_gating`` and the JAX gating kernel, and the CPU wrappers.

Tolerances: run tables, plans, ranks and counts are integers, compared
exactly.  The quantized products: f32 activations agree with JAX to 1e-5
(the scale multiplies the sum instead of each weight: one more f32 rounding
per output); bf16 activations to 2e-2 of the largest output, the kernels'
bf16 tolerance on the card (``chip_smoke.py`` BF16_TOL), since the JAX
kernel rounds every dequantized weight to bf16 and the tensor-core kernel
does not; against the port's grouped version of the same order (kernel 5's)
on the same buffer, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import expert_mlp_quant as jk3
from repro.kernels.moe_gating import gating_kernel as jgating_kernel
from repro.kernels.ref import gating_ref
from repro.quant import qarrays as jq
from repro_torch.core.gating import expert_capacity, top_k_gating
from repro_torch.kernels import expert_mlp_grouped as gk
from repro_torch.kernels import expert_mlp_quant as tk3
from repro_torch.kernels import moe_gating as tk1
from repro_torch.quant import qarrays as tq

TILE = gk.TILE


def check_capacity_table(table, fill, C, R):
    """The run table's rules, from the fill alone: every expert's live tiles
    [e tpe, e tpe + L_e) covered once, in expert order, by runs of at most R
    tiles starting R apart from the expert's first tile; no tile past them."""
    E, tpe = len(fill), C // TILE
    nt = E * tpe
    assert table.shape == (2 * nt + 2,) and table.dtype == torch.int32
    L = [(min(max(int(f), 0), C) + TILE - 1) // TILE for f in fill]
    want = [(e * tpe + i, e * tpe + min(i + R, L[e])) for e in range(E) for i in range(0, L[e], R)]
    assert gk.table_runs(table) == want
    n = int(table[-1])
    assert n == len(want) and int(table[n]) == sum(L) <= nt
    return n


CAPACITY_CASES = {
    # name: (fill, C, R)
    "decode, four live experts": ([0, 1, 0, 0, 2, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], 8, 1),
    "dead experts at both ends": ([0, 0, 5, 8, 3, 0, 0], 16, 1),
    "fill past C": ([40, 3, 0, 17, 9], 16, 1),
    "fill 0 everywhere": ([0, 0, 0, 0], 8, 1),
    "C 136, runs of 8": ([136, 109, 0, 57, 64, 65, 1, 9000], 136, 8),
    "C 136, runs of 1": ([136, 109, 0, 57], 136, 1),
    "runs of 16 past the expert": ([24, 130, 7], 128, 16),
    "negative fill": ([-3, 4, 0], 8, 1),
}


@pytest.mark.parametrize("case", list(CAPACITY_CASES))
def test_capacity_run_table_plain(case):
    fill, C, R = CAPACITY_CASES[case]
    table = gk.capacity_run_table_plain(torch.tensor(fill, dtype=torch.int32), C, R)
    n = check_capacity_table(table, fill, C, R)
    if case == "fill 0 everywhere":
        assert n == 0 and int(table[0]) == 0
    if case == "C 136, runs of 8":  # 17 tiles: runs of 8, 8, 1; 109 rows: 8, 6
        assert gk.table_runs(table)[:5] == [(0, 8), (8, 16), (16, 17), (17, 25), (25, 31)]


@pytest.mark.parametrize("seed", range(6))
def test_capacity_run_table_fits_any_fill(seed):
    """Random fills, from empty to far past C (and negative): the table
    holds every run in its 2 E C / 8 + 2 entries."""
    rng = np.random.default_rng(seed)
    E, C = int(rng.integers(1, 40)), 8 * int(rng.integers(1, 20))
    fill = rng.integers(-5, 3 * C, E) * (rng.random(E) < 0.7)
    for R in (1, 8, 16):
        check_capacity_table(gk.capacity_run_table_plain(torch.tensor(fill, dtype=torch.int32), C, R),
                             fill.tolist(), C, R)


def test_capacity_table_of_full_buffers_is_the_grouped_one():
    """With every expert full (fill >= C) the capacity buffer is the grouped
    layout of te = t // tpe with every row used, and the two tables agree."""
    E, C = 5, 24
    tpe = C // TILE
    for R in (1, 2, 8):
        cap = gk.capacity_run_table_plain(torch.full((E,), C + 3, dtype=torch.int32), C, R)
        te = (torch.arange(E * tpe) // tpe).to(torch.int32)
        grp = gk.run_table_plain(te, torch.tensor([E * C], dtype=torch.int32), R)
        assert torch.equal(cap, grp)


@pytest.mark.parametrize("seed", range(8))
def test_capacity_grid_bound_covers_the_runs(seed):
    """For every fill whose rows hold at most n_assign assignments
    (sum of min(fill, C) <= n_assign, as the gating's counts of T*K slots
    do), the grid's rows bound the runs; without n_assign the bound holds
    for any fill."""
    rng = np.random.default_rng(100 + seed)
    E, C = int(rng.integers(1, 130)), 8 * int(rng.integers(1, 18))
    n_assign = int(rng.integers(1, E * C + 1))
    ids = rng.integers(0, E, n_assign)  # n_assign assignments, drops included
    fill = np.bincount(ids, minlength=E)
    assert np.minimum(fill, C).sum() <= n_assign
    for R in (1, 8):
        n = int(gk.capacity_run_table_plain(torch.tensor(fill, dtype=torch.int32), C, R)[-1])
        assert n <= gk.capacity_max_runs(E, C, R, n_assign) <= E * -(-(C // TILE) // R)
        wild = rng.integers(0, 4 * C, E)
        assert int(gk.capacity_run_table_plain(torch.tensor(wild, dtype=torch.int32), C, R)[-1]) \
            <= gk.capacity_max_runs(E, C, R)


@pytest.mark.parametrize("T,K,E,bits,n_assign,plan", [
    (4, 1, 128, 8, 4, (1, 0, 3)),  # static decode: C 8, 4 grid rows, the down pass split
    (8, 1, 128, 8, 8, (1, 0, 3)),  # the continuous engine's 8 slots
    (256, 1, 128, 8, 256, (1, 0, 1)),  # a 256-token prefill: C 8, 128 grid rows
    (13926, 1, 128, 8, 13926, (8, 2, 1)),  # C 136: runs of 8
    (4, 1, 128, 8, None, (1, 0, 1)),  # no n_assign: 128 rows, no split
    (256, 8, 384, 8, 2048, (1, 0, 1)),  # kimi-k2's width: C 8
    (1, 1, 128, 4, 1, (1, 0, 4)),  # int4 splits 4 ways, as kernel 5
])
def test_capacity_mma_plan(T, K, E, bits, n_assign, plan):
    C = expert_capacity(T, E, K, 1.25)
    assert tuple(gk.capacity_mma_plan(E, C, n_assign, bits)) == plan
    if plan[2] > 1:
        assert gk.capacity_max_runs(E, C, 1, n_assign) <= gk.SPLIT_RUNS


def test_kernel3_variant_rule():
    """bf16 activations at widths that are multiples of 256 (llama4's 5120 /
    8192) take the tensor-core kernel; f32 and other widths the CUDA-core
    one: a rule of dtype and shapes alone."""
    assert gk.kernel_variant(torch.bfloat16, 5120, 8192, 8) == "mma"
    assert gk.kernel_variant(torch.float32, 5120, 8192, 8) == "fma"
    assert gk.kernel_variant(torch.bfloat16, 128, 64, 8) == "fma"
    assert gk.kernel_variant(torch.bfloat16, 7168, 2048, 8) == "mma"


def capacity_inputs(seed, dtype, E=6, C=16, D=32, F=64):
    """A buffer with empty, partly filled and full experts (rows past each
    fill zero), its fill, and int8 weights quantized from the same values on
    both sides."""
    rng = np.random.default_rng(seed)
    fill = np.array([0, 3, C, 0, 11, 5][:E], np.int32)
    xe = np.zeros((E, C, D), np.float32)
    for e in range(E):
        xe[e, : fill[e]] = rng.standard_normal((fill[e], D))
    w = {n: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for n, s in (("wi", (E, D, F)), ("wg", (E, D, F)), ("wo", (E, F, D)))}
    if dtype == torch.bfloat16:  # bf16 values on both sides
        xe = torch.from_numpy(xe).bfloat16().float().numpy()
        w = {n: torch.from_numpy(v).bfloat16().float().numpy() for n, v in w.items()}
    return xe, fill, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_mlp_quant_mma_plain_vs_jax(dtype):
    """``expert_mlp_quant_mma_plain`` ((x . q) * s, the tensor-core kernel's
    order) against the JAX package's kernel 3 (Pallas, interpret mode) and
    ``expert_mlp_quant_ref`` on the same quantized weights; dead rows zero."""
    xe, fill, w = capacity_inputs(3, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jw = {n: jq.QuantizedArray.quantize(jnp.asarray(w[n], jdt), bits=8) for n in w}
    tw = {n: tq.QuantizedArray.quantize(torch.from_numpy(w[n]).to(dtype), bits=8) for n in w}
    for n in w:  # the same quantized values and scales on both sides
        np.testing.assert_array_equal(tw[n].q.numpy(), np.asarray(jw[n].q))
        np.testing.assert_array_equal(tw[n].scale.numpy(), np.asarray(jw[n].scale))
    jx = jnp.asarray(xe, jdt)
    kern = np.asarray(jk3.expert_mlp_quant(jx, jw["wi"], jw["wg"], jw["wo"], interpret=True)
                      .astype(jnp.float32))
    ref = np.asarray(jk3.expert_mlp_quant_ref(jx, jw["wi"], jw["wg"], jw["wo"]).astype(jnp.float32))
    tx = torch.from_numpy(xe).to(dtype)
    out = tk3.expert_mlp_quant_mma_plain(tx, tw["wi"], tw["wg"], tw["wo"], torch.from_numpy(fill))
    out = out.float().numpy()
    for want in (kern, ref):
        if dtype == torch.float32:
            np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)
        else:
            assert np.abs(out - want).max() <= 2e-2 * np.abs(want).max()
    for e, f in enumerate(fill):
        assert (out[e, f:] == 0).all()


def test_mma_order_is_kernel5s_on_the_capacity_layout():
    """The capacity buffer is the grouped layout with tiles t -> t / tpe:
    the capacity version of the tensor-core order equals kernel 5's on that
    layout, bit for bit."""
    xe, fill, w = capacity_inputs(4, torch.bfloat16)
    tw = {n: tq.QuantizedArray.quantize(torch.from_numpy(w[n]).bfloat16(), bits=8) for n in w}
    E, C, D = xe.shape
    tx = torch.from_numpy(xe).bfloat16()
    cap = tk3.expert_mlp_quant_mma_plain(tx, tw["wi"], tw["wg"], tw["wo"], torch.from_numpy(fill))
    te = (torch.arange(E * C // TILE) // (C // TILE)).to(torch.int32)
    grp = gk.grouped_mlp_quant_mma_plain(tx.reshape(E * C, D), te, tw["wi"], tw["wg"], tw["wo"])
    assert torch.equal(cap.reshape(E * C, D), grp)


def gating_logits(T, E, seed, case):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E)).astype(np.float32)
    if case == "ties":
        x = np.round(x, 1)
        x[::5] = 0.25  # whole rows of equal logits
    if case == "drops":
        x[:, 3] += 3.0  # most tokens to expert 3, past its capacity
    return x


@pytest.mark.parametrize("T,E,K,case", [
    (4, 128, 1, "random"),  # static decode
    (384, 128, 1, "drops"),  # three JAX tiles, a drop-heavy router
    (384, 16, 2, "ties"),
    (256, 384, 8, "random"),  # kimi-k2's width: 2048 slots, two chunks
    (256, 64, 8, "ties"),
])
def test_rank_scan_vs_jax_gating_kernel(T, E, K, case):
    """The kernel's rank order against ``top_k_gating`` and the JAX gating
    kernel (Pallas, interpret mode): the same positions, keep and counts for
    a capacity that drops."""
    logits = gating_logits(T, E, T + E + K, case)
    cap = expert_capacity(T, E, K, 1.25)
    g, counts = tk1.gating_plain(torch.from_numpy(logits), K, cap)
    chunk = 32 * min(T, 8)  # the one-launch rank block: a warp a token, up to 8
    ranks, scan_counts = tk1.positions_scan_plain(g.expert_idx, E, chunk)
    want = np.asarray(jgating_kernel(jnp.asarray(logits), K, cap, interpret=True)[2]).reshape(-1)
    kept = ranks < cap
    np.testing.assert_array_equal(np.where(kept.numpy(), ranks.numpy(), cap - 1), want)
    np.testing.assert_array_equal(kept.numpy(), g.keep.reshape(-1).numpy())
    np.testing.assert_array_equal(scan_counts.numpy(), counts.numpy())
    if case == "drops":
        assert not kept.all()


@pytest.mark.parametrize("chunk", [256, 1024])  # the one-launch rank block, the rank launch's
@pytest.mark.parametrize("T,E,K,case", [
    (13926, 128, 1, "random"),  # the 13926-token prefill, past the one-launch bound
    (2500, 64, 8, "ties"),  # 20000 slots
    (5000, 16, 4, "drops"),
])
def test_rank_scan_many_chunks(T, E, K, case, chunk):
    """Past the one-launch bound, up to 20000 slots, in chunks of either
    rank block's width: the chunked scan's ranks equal the stable ranks of
    ``top_k_gating`` and of the JAX package's ``gating_ref``, and its counts
    the assignments."""
    logits = gating_logits(T, E, T, case)
    assert T * K > tk1.ONE_LAUNCH_SLOTS
    g = top_k_gating(torch.from_numpy(logits), K, T * K)
    ranks, counts = tk1.positions_scan_plain(g.expert_idx, E, chunk)
    np.testing.assert_array_equal(ranks.numpy(), g.position.reshape(-1).numpy())
    jpos = np.asarray(gating_ref(jnp.asarray(logits), K, T * K)[2]).reshape(-1)
    np.testing.assert_array_equal(ranks.numpy(), jpos)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(g.expert_idx.reshape(-1).numpy(),
                                                              minlength=E))


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU the kernel 1 and kernel 3 wrappers launch nothing and
    count no variant; the capacity run table is its plain version."""
    xe, fill, w = capacity_inputs(5, torch.bfloat16)
    tw = {n: tq.QuantizedArray.quantize(torch.from_numpy(w[n]).bfloat16(), bits=8) for n in w}
    for counter in (tk3.launches, tk3.variant_launches, tk1.launches, tk1.variant_launches):
        for k in counter:
            counter[k] = 0
    tx, tf = torch.from_numpy(xe).bfloat16(), torch.from_numpy(fill)
    out = tk3.expert_mlp_quant(tx, tw["wi"], tw["wg"], tw["wo"], tf, n_assign=24)
    assert torch.equal(out, tk3.expert_mlp_quant_plain(tx, tw["wi"], tw["wg"], tw["wo"], tf))
    logits = torch.from_numpy(gating_logits(40, 8, 1, "ties"))
    g, counts = tk1.gating(logits, 2, 8)
    pg, pc = tk1.gating_plain(logits, 2, 8)
    for a, b in zip((*g, counts), (*pg, pc)):
        assert torch.equal(a, b)
    assert not any(tk3.launches.values()) and not any(tk3.variant_launches.values())
    assert not any(tk1.launches.values()) and not any(tk1.variant_launches.values())
    assert torch.equal(gk.capacity_run_table(tf, 16, 1), gk.capacity_run_table_plain(tf, 16, 1))


@pytest.mark.parametrize("one_launch", [True, False])
def test_cpu_gating_paths_take_the_plain_version(one_launch):
    """Either path of kernel 1 named on the CPU (as the quick loop names
    them on the card) is the plain version and counts no launch."""
    for counter in (tk1.launches, tk1.variant_launches):
        for k in counter:
            counter[k] = 0
    logits = torch.from_numpy(gating_logits(40, 8, 1, "drops"))
    g, counts = tk1._gating(logits, 1, 8, True, one_launch)
    pg, pc = tk1.gating_plain(logits, 1, 8)
    for a, b in zip((*g, counts), (*pg, pc)):
        assert torch.equal(a, b)
    assert not any(tk1.launches.values()) and not any(tk1.variant_launches.values())
