"""Grouped (dropless) expert SwiGLU MLP: the wrappers of the hand-written
Hopper kernels ``csrc/grouped_mlp_mma.cu`` (tensor cores, bf16 activations)
and ``csrc/grouped_mlp.cu`` (CUDA cores: f32 activations, other shapes), and
their plain PyTorch versions.

``grouped_mlp`` replaces ``repro/kernels/expert_mlp_grouped.py::grouped_mlp_kernel``
(the TPU kernel 4, weights in the input type); ``grouped_mlp_quant`` replaces
``::grouped_mlp_quant_kernel`` (kernel 5, MoQ int8 or int4 weights with f32
per-output-column scales, dequantized inside the kernel).  The designs and
bounds are in the sources' notes; ``kernel_variant`` picks one from the dtype,
the widths and the bits alone.  A tensor on the CPU takes the plain version;
a CUDA tensor launches a kernel or raises.  ``launches`` counts the wrappers'
kernel launches, so a run can show that its main path went through the
kernel, and ``variant_launches`` which of the two kernels each call took.
The tensor-core kernel also computes kernel 3 over the capacity buffer
(``kernels/expert_mlp_quant.py``): its plan, grid bound and run table for
that layout are here too (``capacity_mma_plan``, ``capacity_max_runs``,
``capacity_run_table_plain``).

Training: ``grouped_mlp`` under grad is ``GroupedMlpFn``, kernel 4 forward
and kernel 4b (``csrc/grouped_mlp_bwd.cu``) backward, or their plain
versions on the CPU (``grouped_mlp_backward_plain``: explicit formulas, not
autograd).  4b and kernel 2's backward 2b share their device code and its
launch (``launch_backward``); ``backward_variant`` picks tensor cores
(``wgmma``) or CUDA cores from (dtype, D, F), and ``backward_plan_plain``
mirrors the tables the tensor-core passes walk.  Kernel 5 (MoQ int8 / int4
weights) keeps refusing under grad: MoQ weights are post-training.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.quant.qarrays import QuantizedArray, dequantize_values
from repro_torch.kernels.no_backward import EXPERT_KERNELS, quant_tensors, refuse_grad
from repro_torch.kernels import account

TILE = 8  # token rows per tile; must equal dispatch_grouped.GROUPED_TILE
VEC = 4  # columns a kernel lane loads at once: D and F must be multiples
# F block of the TPU kernel (repro/kernels/expert_mlp.py BLOCK_F): the quant
# kernel's compatibility rule keeps it, so both packages pick the same path
BLOCK_F = 256

# D and F multiples of this take the tensor-core kernel (its widest blocks)
MMA_COLS = 256

launches = {"grouped_mlp": 0, "grouped_mlp_quant": 0, "grouped_mlp_backward": 0}
variant_launches = {"grouped_mlp_mma": 0, "grouped_mlp_fma": 0, "grouped_mlp_quant_mma": 0,
                    "grouped_mlp_quant_fma": 0, "grouped_mlp_backward_wgmma": 0,
                    "grouped_mlp_backward_fma": 0, "expert_mlp_backward_wgmma": 0,
                    "expert_mlp_backward_fma": 0}

_C_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_C_ARGS_QUANT = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library():
    lib = build.load_library("grouped_mlp")
    for fn, args in ((lib.grouped_mlp_bf16, _C_ARGS), (lib.grouped_mlp_f32, _C_ARGS),
                     (lib.grouped_mlp_quant_bf16, _C_ARGS_QUANT),
                     (lib.grouped_mlp_quant_f32, _C_ARGS_QUANT)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


_mma_bound = None  # the library whose signatures are bound


def _mma_library():
    """The tensor-core library, its signatures bound once per loaded copy."""
    global _mma_bound
    lib = build.load_library("grouped_mlp_mma")
    if lib is not _mma_bound:
        for fn, args in ((lib.grouped_mlp_mma, [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7),
                         (lib.expert_mlp_mma, [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7),
                         (lib.grouped_mlp_runs, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2),
                         (lib.expert_mlp_mma_runs, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)):
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _mma_bound = lib
    return lib


def kernel_variant(dtype: torch.dtype, D: int, F: int, bits: int) -> str:
    """Which kernel a call on the card takes, from (dtype, D, F, bits) alone:
    ``"mma"`` (``grouped_mlp_mma.cu``, tensor cores) for bf16 activations with
    bf16 (bits 0), int8 or int4 weights and D, F multiples of ``MMA_COLS``;
    ``"fma"`` (``grouped_mlp.cu``, f32 FMAs) for everything else: f32
    activations (tensor cores would be TF32), other widths."""
    if dtype == torch.bfloat16 and bits in (0, 8, 4) and D % MMA_COLS == 0 and F % MMA_COLS == 0:
        return "mma"
    return "fma"


class MmaPlan(NamedTuple):
    """A launch of the tensor-core kernel: runs of at most ``R`` tiles,
    ``plan`` (``launch_plan`` in the source), and the blocks that share the
    down pass's contraction."""
    R: int
    plan: int
    split: int = 1


# plan 0 grids of at most this many rows (T*K <= 8 on the dispatch's buffer)
# split the down pass's contraction, across this many blocks by weight bits
SPLIT_RUNS = 15
SPLIT = {0: 3, 8: 3, 4: 4}


def mma_plan(n_tiles: int, num_experts: int, bits: int) -> MmaPlan:
    """The tensor-core kernel's launch for a buffer of ``n_tiles`` tiles over
    ``num_experts`` experts, from the static bound on its assignments,
    ``T*K <= Ct - 7E + 7``: groups of about one tile (under 8 rows an
    expert: decode, a 256-token prefill) take runs of one tile (plan 0),
    and a grid of at most ``SPLIT_RUNS`` rows (decode at up to 8 tokens)
    splits the down pass's contraction across ``SPLIT[bits]`` blocks, so a
    few live experts keep more SMs streaming; bf16 weights with groups of 64
    rows or more (a 16384-token prefill) runs of 16 tiles (plan 1); the rest
    runs of 8 (plan 2).  Measured on the card (``launch.expert_kernels
    --splits``, PERF.md)."""
    rows = n_tiles * TILE - (TILE - 1) * num_experts + TILE - 1
    if rows < 8 * num_experts:
        if max_runs(n_tiles, num_experts, 1) <= SPLIT_RUNS:
            return MmaPlan(1, 0, SPLIT[bits])
        return MmaPlan(1, 0)
    if bits == 0 and rows >= 64 * num_experts:
        return MmaPlan(16, 1)
    return MmaPlan(8, 2)


def capacity_max_runs(num_experts: int, C: int, R: int, n_assign: Optional[int] = None) -> int:
    """The tensor-core kernel's grid rows over the capacity buffer
    (``capacity_max_runs_of`` in the source): at most ceil(C / 8 / R) runs
    an expert, and, given ``n_assign`` (the T*K assignments the buffer can
    hold at most), at most n_assign runs, since each run holds a filled row.
    A ``fill`` past the bound is still computed whole (a block takes several
    runs)."""
    bound = num_experts * -(-(C // TILE) // R)
    if n_assign:
        bound = min(bound, n_assign)
    return max(1, bound)


def capacity_mma_plan(num_experts: int, C: int, n_assign: Optional[int], bits: int) -> MmaPlan:
    """The tensor-core kernel's launch over the capacity buffer [E, C, D]:
    buffers of at most 2 tiles an expert (C <= 16: every served decode and
    256-token prefill, where ``expert_capacity`` gives C = 8) take runs of
    one tile (plan 0), and a grid of at most ``SPLIT_RUNS`` rows (T*K <= 15)
    splits the down pass across ``SPLIT[bits]`` blocks, as ``mma_plan``
    does on the grouped buffer; deeper buffers (C = 136 at a 13926-token
    prefill) runs of 8 (plan 2).  Plan 1 takes bf16 weights only."""
    if C // TILE <= 2:
        if capacity_max_runs(num_experts, C, 1, n_assign) <= SPLIT_RUNS:
            return MmaPlan(1, 0, SPLIT[bits])
        return MmaPlan(1, 0)
    return MmaPlan(8, 2)


def max_runs(n_tiles: int, num_experts: int, R: int) -> int:
    """The tensor-core kernel's grid rows (``max_runs_of`` in the source): a
    static bound on the run count of the dispatch's buffers, where a run
    holds at least one live tile, a live tile at least one of the
    T*K <= Ct - 7E + 7 assignments, and each expert adds at most one
    partial run to ceil(n_tiles / R).  A ``te`` with more runs is still
    computed whole (a block takes several)."""
    assignments = n_tiles * TILE - (TILE - 1) * num_experts + TILE - 1
    return max(1, min(n_tiles, -(-n_tiles // R) + num_experts, assignments))


def _table(nt: int, starts: torch.Tensor, ends: torch.Tensor, live: int) -> torch.Tensor:
    """A run table of ``nt`` tiles: [2 nt + 2] int32, entries 0 .. n_runs - 1
    the runs' first tiles, entry n_runs the live tile count, entries
    nt + 1 .. nt + n_runs the runs' ends (one past their last tiles), and
    n_runs in the last entry; entries no run uses are 0 (the kernel leaves
    them unwritten)."""
    n = starts.numel()
    out = torch.zeros(2 * nt + 2, dtype=torch.int32)
    out[:n] = starts.to(torch.int32)
    out[n] = live
    out[nt + 1: nt + 1 + n] = ends.to(torch.int32)
    out[-1] = n
    return out


def table_runs(table: torch.Tensor) -> list:
    """The (first tile, end) pairs of a run table."""
    nt = (table.shape[0] - 2) // 2
    # analysis: allow(host-cast) — reads a run table back for a check, not on the card path
    n = int(table[-1])
    # analysis: allow(host-asarray) — the same
    return list(zip(table[:n].tolist(), table[nt + 1: nt + 1 + n].tolist()))


def tables_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two run tables hold the same runs and live count (entries no
    run uses are not compared: the kernel leaves them unwritten)."""
    # analysis: allow(host-cast) — compares two run tables for a check, not on the card path
    n = int(a[-1])
    # analysis: allow(host-cast) — the same
    if a.shape != b.shape or n != int(b[-1]) or int(a[n]) != int(b[n]):
        return False
    # analysis: allow(host-asarray) — the same
    return table_runs(a.cpu()) == table_runs(b.cpu())


def run_table_plain(te: torch.Tensor, rows_used: torch.Tensor, R: int) -> torch.Tensor:
    """The tensor-core kernel's run table of the grouped layout
    (``runs_kernel``; layout in ``_table``): runs of at most R consecutive
    live tiles of one expert, in order, each ending where the next starts;
    the live tile count is ``rows_used / TILE``.  A run starts at every
    (multiple of R)-th tile of an expert's group; tiles at or past
    ``rows_used`` join none.  Any ``te`` fits: n_runs <= live <= n_tiles."""
    nt = te.shape[0]
    # analysis: allow(host-cast) — the run table's plain version, CPU only
    live = min(int(rows_used.reshape(-1)[0]) // TILE, nt)
    e = te[:live].long()
    first = torch.ones(live, dtype=torch.bool)
    first[1:] = e[1:] != e[:-1]
    idx = torch.arange(live)
    group = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0).values
    starts = idx[(idx - group) % R == 0]
    ends = torch.cat([starts[1:], torch.tensor([live])]) if starts.numel() else starts
    return _table(nt, starts, ends, live)


def capacity_run_table_plain(fill: torch.Tensor, C: int, R: int) -> torch.Tensor:
    """The tensor-core kernel's run table of the capacity layout
    (``capacity_runs_kernel``; layout in ``_table``): expert e's live tiles
    [e C/8, e C/8 + L_e), L_e = ceil(min(fill[e], C) / 8) (a fill past C,
    the gating's count of an overflowing expert, cut to C; a negative one to
    0), cut into runs of at most R, in expert order.  Any ``fill`` fits:
    n_runs <= live <= E C / 8."""
    E, tpe = fill.shape[0], C // TILE
    # analysis: allow(host-asarray) — the run table's plain version, CPU only
    L = (fill.cpu().long().clamp(0, C) + TILE - 1) // TILE
    starts, ends = [], []
    for e in range(E):
        for i in range(0, int(L[e]), R):
            starts.append(e * tpe + i)
            ends.append(e * tpe + min(i + R, int(L[e])))
    return _table(E * tpe, torch.tensor(starts, dtype=torch.long),
                  torch.tensor(ends, dtype=torch.long), int(L.sum()))


def grouped_mlp_plain(
    xg: torch.Tensor,  # [Ct, D] — tile-padded, expert-sorted token buffer
    te: torch.Tensor,  # [Ct / TILE] int32 — tile -> expert id
    wi: torch.Tensor,  # [E, D, F]
    wg: torch.Tensor,  # [E, D, F]
    wo: torch.Tensor,  # [E, F, D]
    rows_used: Optional[torch.Tensor] = None,  # [1] int32
) -> torch.Tensor:
    """The kernel's function in PyTorch, as ``grouped_mlp_ref`` of the JAX
    package computes it, but looping over the distinct experts of ``te``
    instead of gathering ``wi[te]`` (at full width that gather would copy
    tens of GB).  f32 products, activation rounded to the input type."""
    return _experts_plain(xg, te, rows_used, lambda e: (wi[e], wg[e], wo[e]))


def _experts_plain(xg, te, rows_used, weights_of, scales_of=None):
    """Loop over the distinct experts of the live tiles: ``weights_of(e)``
    gives expert e's (wi, wg, wo) in full precision; ``scales_of(e)``, if
    given, their per-column scales, which multiply each f32 sum."""
    Ct, D = xg.shape
    nt = te.shape[0]
    tile_e = te.long()
    live = torch.ones(nt, dtype=torch.bool, device=xg.device)
    if rows_used is not None:
        live = torch.arange(nt, device=xg.device) * (Ct // nt) < rows_used.to(xg.device)
    row_e = torch.where(live, tile_e, -1).repeat_interleave(Ct // nt)
    out = torch.zeros_like(xg)
    # analysis: allow(host-asarray) — plain version, CPU only
    for e in torch.unique(tile_e[live]).tolist():
        wi, wg, wo = weights_of(e)
        si, sg, so = scales_of(e) if scales_of is not None else (1.0, 1.0, 1.0)
        rows = row_e == e
        x = xg[rows].float()
        h = (x @ wi.float()) * si
        g = (x @ wg.float()) * sg
        act = (F.silu(g) * h).to(xg.dtype)
        out[rows] = ((act.float() @ wo.float()) * so).to(xg.dtype)
    return out


# ---------------------------------------------------------------------------
# Kernels 2b and 4b: the backward of the SwiGLU expert MLP
# ---------------------------------------------------------------------------

RUN_TILES = 8  # tiles a run of the backward's CUDA-core row passes (RUN_TILES in the source)
BWD_CHUNK = 64  # an expert's packed rows are a multiple of this (CHUNK in the source)
BWD_WINDOW = 192  # packed rows a tensor-core row-pass window (WIN in the source)
MAX_BWD_EXPERTS = 1024  # experts its table kernel takes (MAX_E)
BWD_MMA_COLS = 128  # bf16 with D and F multiples of this takes the tensor cores


def backward_variant(dtype: torch.dtype, D: int, F: int) -> str:
    """Which passes a backward call on the card takes (``takes_mma`` in the
    source): ``"wgmma"`` (tensor cores, TMA-fed) for bf16 with D and F
    multiples of ``BWD_MMA_COLS``, ``"fma"`` (f32 FMAs on the CUDA cores)
    otherwise."""
    if dtype == torch.bfloat16 and D % BWD_MMA_COLS == 0 and F % BWD_MMA_COLS == 0:
        return "wgmma"
    return "fma"


def backward_max_runs(n_tiles: int, num_experts: int) -> int:
    """The grid rows of the backward's CUDA-core row passes
    (``max_runs_of``): runs of at most ``RUN_TILES`` of one expert's live
    tiles, at most ceil(n_tiles / RUN_TILES) + E of them, and at most one a
    tile."""
    return max(1, min(n_tiles, -(-n_tiles // RUN_TILES) + num_experts))


def backward_max_windows(n_tiles: int, num_experts: int) -> int:
    """The grid rows of the tensor-core row passes (``max_wins_of``): expert
    e's c live tiles take ceil(c / 24) windows of ``BWD_WINDOW`` rows, so at
    most n_tiles // 24 + min(E, n_tiles) in all."""
    return n_tiles // (BWD_WINDOW // TILE) + min(num_experts, n_tiles)


def backward_packed_rows(n_tiles: int, num_experts: int) -> int:
    """Rows of the packed buffers (``packed_rows_of``): each expert's 8 c
    rows padded to a multiple of ``BWD_CHUNK``, at most 8 n_tiles + 56
    min(E, n_tiles)."""
    return TILE * n_tiles + (BWD_CHUNK - TILE) * min(num_experts, n_tiles)


def backward_table_size(n_tiles: int, num_experts: int) -> int:
    """int32 values of the backward's tile tables
    (``expert_mlp_backward_table_size``)."""
    return (3 * n_tiles + 3 * (num_experts + 1) + 3 * backward_max_runs(n_tiles, num_experts)
            + 3 * backward_max_windows(n_tiles, num_experts)
            + backward_packed_rows(n_tiles, num_experts) + 3)


def backward_scratch_size(n_tiles: int, num_experts: int, D: int, F: int) -> int:
    """Values of the activation type in the backward's scratch
    (``expert_mlp_backward_scratch_size``): packed a, du, dg [P, F] and x, dy
    [P, D], P = ``backward_packed_rows`` (the CUDA-core passes use the first
    3 rows F)."""
    return backward_packed_rows(n_tiles, num_experts) * (3 * F + 2 * D)


def backward_tiles_plain(num_experts: int, *, fill=None, C: int = 0, te=None, rows_used=None):
    """(tile_e, tile_rows) of the backward's table kernel (``prep_kernel``):
    each tile's expert and live rows, over the capacity buffer (``fill`` [E],
    ``C``: expert t // (C / 8), rows up to min(fill, C) live) or the grouped
    one (``te``, ``rows_used``: tiles at or past it dead, experts clamped to
    [0, E))."""
    if fill is not None:
        tpe = C // TILE
        t = torch.arange(num_experts * tpe)
        live = fill.cpu().long().clamp(0, C)[t // tpe]
        return t // tpe, (live - (t % tpe) * TILE).clamp(0, TILE)
    t = torch.arange(te.shape[0])
    used = int(rows_used.reshape(-1)[0])
    return te.cpu().long().clamp(0, num_experts - 1), (used - t * TILE).clamp(0, TILE)


class BackwardPlan(NamedTuple):
    """The tables the tensor-core backward walks (``Tab`` in the source)."""
    order: torch.Tensor  # [live tiles] the live tiles by expert, in tile order within one
    poff: torch.Tensor  # [E + 1] expert e's packed rows [poff[e], poff[e + 1])
    prow: torch.Tensor  # [backward_packed_rows] each packed row's buffer row, -1 dead / padding
    windows: list  # (first packed row, end, expert) of each row-pass block, in expert order


def backward_plan_plain(tile_e: torch.Tensor, tile_rows: torch.Tensor, num_experts: int) -> BackwardPlan:
    """``prep_kernel``'s tensor-core tables in PyTorch: expert e's live
    tiles listed in tile order and laid end to end as packed rows from
    poff[e], padded with empty rows to a multiple of ``BWD_CHUNK``; windows
    of at most ``BWD_WINDOW`` of them.  A tile with no live row joins
    none; an expert with none has no packed row and no window."""
    nt = tile_e.shape[0]
    prow = torch.full((backward_packed_rows(nt, num_experts),), -1, dtype=torch.long)
    order, poff, windows, q = [], [0], [], 0
    for e in range(num_experts):
        # analysis: allow(tracer-branch) — plain mirror of the backward's plan, CPU only
        tiles = [t for t in range(nt) if tile_rows[t] > 0 and tile_e[t] == e]
        order += tiles
        for i, t in enumerate(tiles):
            # analysis: allow(host-cast) — the same
            for r in range(int(tile_rows[t])):
                prow[q + TILE * i + r] = t * TILE + r
        padded = -(-TILE * len(tiles) // BWD_CHUNK) * BWD_CHUNK
        windows += [(w, min(w + BWD_WINDOW, q + padded), e) for w in range(q, q + padded, BWD_WINDOW)]
        q += padded
        poff.append(q)
    return BackwardPlan(torch.tensor(order, dtype=torch.long), torch.tensor(poff), prow, windows)


def backward_pass_c_tiles(num_experts: int, M: int, N: int, bn: int) -> list:
    """Pass C's output tiles in the order its persistent blocks take them
    (block b: tiles b, b + grid, ...): (expert, first row, first column) of
    each 128 x ``bn`` tile of an [E, M, N] gradient, columns fastest; a
    last tile past N (N a multiple of 128, ``bn`` 256) stores only its first
    columns."""
    return [(e, m, n) for e in range(num_experts) for m in range(0, M, 128) for n in range(0, N, bn)]


def backward_by_plan(x, dy, wi, wg, wo, plan: BackwardPlan):
    """The tensor-core backward's schedule in PyTorch (f64 sums, a, du and
    dg rounded to x's type): x and dy packed by ``plan.prow`` (dead and
    padding rows 0), passes A and B per window (rows past the window's end
    not stored), pass C per 128 x 128 tile over each expert's packed rows in
    chunks of ``BWD_CHUNK``.  Returns (dx, dwi, dwg, dwo) over the buffer
    [rows, D]: what the kernel's plan computes, for the CPU tests."""
    dt = x.dtype
    P = plan.prow.shape[0]
    live = plan.prow >= 0
    src = plan.prow.clamp(min=0)
    xp = torch.where(live[:, None], x.double()[src], 0.0)
    yp = torch.where(live[:, None], dy.double()[src], 0.0)
    E, D, Fd = wi.shape
    act, du, dg = (torch.zeros((P, Fd), dtype=torch.float64) for _ in range(3))
    dx = torch.zeros((x.shape[0], D), dtype=torch.float64)
    for r0, r1, e in plan.windows:
        rows = slice(r0, r1)
        u, g = xp[rows] @ wi[e].double(), xp[rows] @ wg[e].double()
        da = yp[rows] @ wo[e].double().T
        s = torch.sigmoid(g)
        act[rows] = (g * s * u).to(dt).double()
        du[rows] = (da * g * s).to(dt).double()
        dg[rows] = (da * u * s * (1 + g * (1 - s))).to(dt).double()
        got = du[rows] @ wi[e].double().T + dg[rows] @ wg[e].double().T
        keep = live[rows]
        dx[plan.prow[rows][keep]] = got[keep]
    grads = [torch.zeros_like(w, dtype=torch.float64) for w in (wi, wg, wo)]
    for (out, a, b) in ((grads[0], xp, du), (grads[1], xp, dg), (grads[2], act, yp)):
        M, N = out.shape[1:]
        for e, m0, n0 in backward_pass_c_tiles(E, M, N, 128):
            for q in range(int(plan.poff[e]), int(plan.poff[e + 1]), BWD_CHUNK):
                k = slice(q, q + BWD_CHUNK)
                out[e, m0:m0 + 128, n0:n0 + 128] += a[k, m0:m0 + 128].T @ b[k, n0:n0 + 128]
    return (dx.to(dt), *(g.to(w.dtype) for g, w in zip(grads, (wi, wg, wo))))


def swiglu_backward_rows(x, dy, wi, wg, wo, dtype):
    """(dx, dwi, dwg, dwo) in f64 of one expert's rows x [n, D] with output
    gradient dy [n, D], by the kernels' formulas: u = x wi, g = x wg; a =
    silu(g) u rounded to ``dtype`` (the forward's down-projection operand);
    da = dy wo^T; du = da silu(g) and dg = da u s (1 + g (1 - s)), s =
    sigmoid(g), each rounded to ``dtype`` (the operands of the next
    products, as on the card); dx = du wi^T + dg wg^T, dwi = x^T du, dwg =
    x^T dg, dwo = a^T dy.  Summed in f64: between those roundings it is the
    exact gradient, which the kernels' and JAX's f32 sums are held
    against."""
    x, dy = x.double(), dy.double()
    wi, wg, wo = wi.double(), wg.double(), wo.double()
    u, g = x @ wi, x @ wg
    s = torch.sigmoid(g)
    silu = g * s
    a = (silu * u).to(dtype).double()
    da = dy @ wo.T
    du = (da * silu).to(dtype).double()
    dg = (da * u * s * (1 + g * (1 - s))).to(dtype).double()
    return du @ wi.T + dg @ wg.T, x.T @ du, x.T @ dg, a.T @ dy


def grouped_mlp_backward_plain(xg, te, wi, wg, wo, dy, rows_used=None):
    """Kernel 4b's function in PyTorch: (dxg, dwi, dwg, dwo) of
    ``grouped_mlp`` at output gradient ``dy`` [Ct, D], one expert at a time
    over its live tiles (``swiglu_backward_rows``).  Tiles at or past
    ``rows_used`` (the dispatch's trailing tiles, clamped to expert E-1)
    are dead: dx = 0 there, and they add nothing to any weight; an expert no
    live tile names gets zero weight gradients."""
    Ct, D = xg.shape
    nt = te.shape[0]
    live = torch.ones(nt, dtype=torch.bool, device=xg.device)
    if rows_used is not None:
        live = torch.arange(nt, device=xg.device) * TILE < rows_used.to(xg.device)
    row_e = torch.where(live, te.long(), -1).repeat_interleave(TILE)
    dx = torch.zeros_like(xg)
    grads = [torch.zeros_like(w) for w in (wi, wg, wo)]
    # analysis: allow(host-asarray) — plain version, CPU only
    for e in torch.unique(te.long()[live]).tolist():
        rows = row_e == e
        gx, *gw = swiglu_backward_rows(xg[rows], dy[rows], wi[e], wg[e], wo[e], xg.dtype)
        dx[rows] = gx.to(xg.dtype)
        for out, g in zip(grads, gw):
            out[e] = g.to(out.dtype)
    return (dx, *grads)


def grouped_mlp_backward(xg, te, wi, wg, wo, dy, rows_used):
    """(dxg, dwi, dwg, dwo) of ``grouped_mlp`` at ``dy``: kernel 4b on the
    card (one count a call: its table kernel, row passes and weight passes),
    the plain version on the CPU."""
    if account.recorder is not None:
        return account.recorder.kernel("grouped_mlp_backward", grouped_mlp_backward, **locals())
    if xg.device.type == "cpu":
        return grouped_mlp_backward_plain(xg, te, wi, wg, wo, dy, rows_used)
    if xg.device.type != "cuda":
        raise ValueError(f"grouped_mlp_backward: no kernel for device {xg.device}")
    _check(xg, te, wi, wg, wo, rows_used)
    out = launch_backward("grouped_mlp_backward", xg, wi, wg, wo, dy, te=te, rows_used=rows_used)
    launches["grouped_mlp_backward"] += 1
    return out


_bwd_bound = None  # the backward library whose signatures are bound


def _bwd_library():
    global _bwd_bound
    lib = build.load_library("grouped_mlp_bwd")
    if lib is not _bwd_bound:
        tail = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.expert_mlp_backward.argtypes = [ctypes.c_void_p] * 12 + tail
        lib.grouped_mlp_backward.argtypes = [ctypes.c_void_p] * 13 + tail
        lib.expert_mlp_backward_table_size.argtypes = [ctypes.c_int] * 2
        lib.expert_mlp_backward_scratch_size.argtypes = [ctypes.c_int] * 4
        lib.expert_mlp_backward_takes_mma.argtypes = [ctypes.c_int] * 3
        for fn in (lib.expert_mlp_backward, lib.grouped_mlp_backward,
                   lib.expert_mlp_backward_table_size, lib.expert_mlp_backward_takes_mma):
            fn.restype = ctypes.c_int
        lib.expert_mlp_backward_scratch_size.restype = ctypes.c_int64
        _bwd_bound = lib
    return lib


def launch_backward(name, x, wi, wg, wo, dy, *, fill=None, te=None, rows_used=None):
    """Kernel 2b (``fill`` given: x the capacity buffer [E, C, D]) or 4b
    (``te``, ``rows_used``: x the grouped buffer [Ct, D]) on the card, the
    inputs checked by the caller: its outputs, tables and scratch allocated
    here, its launches made in ``csrc/grouped_mlp_bwd.cu``.  Returns (dx,
    dwi, dwg, dwo); counts the variant in ``variant_launches``."""
    E, D, Fd = wi.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"{name}: dy must be a contiguous {x.dtype} tensor of x's shape")
    if E > MAX_BWD_EXPERTS:
        raise ValueError(f"{name}: {E} experts; the kernel takes at most {MAX_BWD_EXPERTS}")
    rows = x.numel() // D
    nt = rows // TILE
    lib = _bwd_library()
    variant = backward_variant(x.dtype, D, Fd)
    if lib.expert_mlp_backward_table_size(nt, E) != backward_table_size(nt, E) or \
            lib.expert_mlp_backward_scratch_size(nt, E, D, Fd) != backward_scratch_size(nt, E, D, Fd) or \
            lib.expert_mlp_backward_takes_mma(int(x.dtype == torch.bfloat16), D, Fd) != (variant == "wgmma"):
        raise RuntimeError(f"{name}: the library's table or scratch size or variant rule differs "
                           f"from the wrapper's")
    tab = torch.empty(backward_table_size(nt, E), dtype=torch.int32, device=x.device)
    scratch = torch.empty(backward_scratch_size(nt, E, D, Fd), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    dwi, dwg, dwo = torch.empty_like(wi), torch.empty_like(wg), torch.empty_like(wo)
    bf = int(x.dtype == torch.bfloat16)
    ptrs = (wi.data_ptr(), wg.data_ptr(), wo.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dwi.data_ptr(), dwg.data_ptr(), dwo.data_ptr(), scratch.data_ptr(), tab.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if fill is not None:
            err = lib.expert_mlp_backward(x.data_ptr(), fill.data_ptr(), *ptrs, E, x.shape[1], D,
                                          Fd, bf, stream)
        else:
            err = lib.grouped_mlp_backward(x.data_ptr(), te.data_ptr(), rows_used.data_ptr(), *ptrs,
                                           nt, E, D, Fd, bf, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    variant_launches[f"{name}_{variant}"] += 1
    return dx, dwi, dwg, dwo


def _expert(w: QuantizedArray, e: int) -> torch.Tensor:
    """Expert e of a quantized [E, Din, Dout] leaf, dequantized to its
    original type."""
    return dequantize_values(w.q[e], w.scale[e], w.bits, w.group_size, w.axis, w.orig_dtype)


def grouped_mlp_quant_plain(
    xg: torch.Tensor,  # [Ct, D]
    te: torch.Tensor,  # [Ct / TILE] int32
    wi: QuantizedArray,  # [E, D, F] (stored [E, D/2, F] at int4)
    wg: QuantizedArray,
    wo: QuantizedArray,  # [E, F, D] (stored [E, F/2, D] at int4)
    rows_used: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 5's function in PyTorch, as ``grouped_mlp_quant_ref`` of the JAX
    package computes it: each touched expert dequantized to the original
    type (any group size), then the products of ``grouped_mlp_plain``.  The
    kernel rounds each dequantized weight to the activation type, the same
    value when the activations are in the weights' original type."""
    return _experts_plain(xg, te, rows_used, lambda e: (_expert(wi, e), _expert(wg, e), _expert(wo, e)))


def grouped_mlp_quant_mma_plain(
    xg: torch.Tensor,
    te: torch.Tensor,
    wi: QuantizedArray,
    wg: QuantizedArray,
    wo: QuantizedArray,
    rows_used: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 5's function in the tensor-core kernel's order: the integer
    weights times the activations summed in f32, then times each output
    column's scale once, ``(x . q) * s`` (per-output-column scales only),
    where ``grouped_mlp_quant_plain`` rounds every dequantized weight to the
    activation type first."""
    def values(w, e):  # the integers, unscaled
        return dequantize_values(w.q[e], torch.ones_like(w.scale[e]), w.bits, 0, w.axis, torch.float32)

    return _experts_plain(xg, te, rows_used, lambda e: (values(wi, e), values(wg, e), values(wo, e)),
                          lambda e: (wi.scale[e], wg.scale[e], wo.scale[e]))


def check_grouped_quant_compat(wi, wg, wo, *, block_f: int = BLOCK_F) -> bool:
    """Whether kernel 5 takes these weights (``_check_grouped_quant_compat`` of
    the JAX package): SwiGLU ``QuantizedArray`` triples with per-output-column
    scales (group_size 0) at 8 or 4 bits, equal bits, d_ff a multiple of the
    F block, even dims to unpack nibbles; plus this kernel's own layout
    rule, D and F multiples of 4."""
    qs = (wi, wg, wo)
    if wg is None or not all(isinstance(q, QuantizedArray) for q in qs):
        return False
    if not all(q.bits in (8, 4) and q.group_size == 0 for q in qs):
        return False
    bits = wi.bits
    if any(q.bits != bits for q in qs):
        return False
    Fd = wi.shape[-1]
    D = wo.shape[-1]
    bf = min(block_f, Fd)
    pack = 2 if bits == 4 else 1
    return Fd % bf == 0 and D % pack == 0 and bf % pack == 0 and D % VEC == 0 and Fd % VEC == 0


def _check(xg, te, wi, wg, wo, rows_used):
    dev = xg.device
    for name, t in (("te", te), ("wi", wi), ("wg", wg), ("wo", wo), ("rows_used", rows_used)):
        if t.device != dev:
            raise ValueError(f"grouped_mlp: {name} is on {t.device}, xg on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_mlp: {name} must be contiguous")
    if not xg.is_contiguous():
        raise ValueError("grouped_mlp: xg must be contiguous")
    if xg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"grouped_mlp: dtype {xg.dtype} not supported (bfloat16, float32)")
    for name, t in (("wi", wi), ("wg", wg), ("wo", wo)):
        if t.dtype != xg.dtype:
            raise TypeError(f"grouped_mlp: {name} is {t.dtype}, xg is {xg.dtype}")
    if te.dtype != torch.int32 or rows_used.dtype != torch.int32 or rows_used.numel() != 1:
        raise TypeError("grouped_mlp: te and rows_used must be int32, rows_used one element")
    Ct, D = xg.shape
    E, _, Fd = wi.shape
    if Ct % TILE or te.shape != (Ct // TILE,):
        raise ValueError(f"grouped_mlp: Ct={Ct} must be a multiple of {TILE} with one te entry per tile")
    if wi.shape != (E, D, Fd) or wg.shape != (E, D, Fd) or wo.shape != (E, Fd, D):
        raise ValueError(f"grouped_mlp: weight shapes {wi.shape} {wg.shape} {wo.shape} do not match D={D}")
    if D % VEC or Fd % VEC:
        raise ValueError(f"grouped_mlp: D={D} and F={Fd} must be multiples of {VEC}")


def grouped_mlp(
    xg: torch.Tensor,
    te: torch.Tensor,
    wi: torch.Tensor,
    wg: torch.Tensor,
    wo: torch.Tensor,
    rows_used: torch.Tensor,
) -> torch.Tensor:
    """[Ct, D] output of tile ``t``'s rows through expert ``te[t]``'s SwiGLU
    MLP.  ``rows_used`` ([1] int32 on the device, ``GroupedLayout.rows_used``):
    tiles at or past it hold no token and give zero rows without reading any
    weight.  Differentiable (``GroupedMlpFn``) when grad is enabled and xg
    or a weight requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xg, wi, wg, wo)):
        return GroupedMlpFn.apply(xg, te, wi, wg, wo, rows_used)
    return _grouped_mlp(xg, te, wi, wg, wo, rows_used)


class GroupedMlpFn(torch.autograd.Function):
    """Kernel 4 forward, kernel 4b backward (plain versions on the CPU);
    saves the inputs only: the backward recomputes u, g and a."""

    @staticmethod
    def forward(ctx, xg, te, wi, wg, wo, rows_used):
        ctx.save_for_backward(xg, te, wi, wg, wo, rows_used)
        return _grouped_mlp(xg, te, wi, wg, wo, rows_used)

    @staticmethod
    def backward(ctx, dy):
        xg, te, wi, wg, wo, rows_used = ctx.saved_tensors
        dx, dwi, dwg, dwo = grouped_mlp_backward(xg, te, wi, wg, wo, dy.contiguous(), rows_used)
        return dx, None, dwi, dwg, dwo, None


def _grouped_mlp(xg, te, wi, wg, wo, rows_used):
    """Kernel 4 (its plain version on the CPU)."""
    if account.recorder is not None:
        return account.recorder.kernel("grouped_mlp", _grouped_mlp, **locals())
    if xg.device.type == "cpu":
        return grouped_mlp_plain(xg, te, wi, wg, wo, rows_used)
    if xg.device.type != "cuda":
        raise ValueError(f"grouped_mlp: no kernel for device {xg.device}")
    Ct, D = xg.shape
    Fd = wi.shape[-1]
    _check(xg, te, wi, wg, wo, rows_used)
    variant = kernel_variant(xg.dtype, D, Fd, 0)
    if variant == "mma":
        out = _launch_mma(xg, te, rows_used, (wi, None), (wg, None), (wo, None), 0, "grouped_mlp")
    else:
        lib = _library()
        fn = lib.grouped_mlp_bf16 if xg.dtype == torch.bfloat16 else lib.grouped_mlp_f32
        act = torch.empty((Ct, Fd), dtype=xg.dtype, device=xg.device)
        out = torch.empty_like(xg)
        with torch.cuda.device(xg.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(xg.data_ptr(), te.data_ptr(), rows_used.data_ptr(), wi.data_ptr(),
                     wg.data_ptr(), wo.data_ptr(), act.data_ptr(), out.data_ptr(),
                     Ct // TILE, D, Fd, stream)
        if err != 0:
            raise RuntimeError(f"grouped_mlp: kernel launch failed with CUDA error {err}")
    launches["grouped_mlp"] += 1
    variant_launches[f"grouped_mlp_{variant}"] += 1
    return out


def _launch_mma(xg, te, rows_used, wi, wg, wo, bits, name, plan: Optional[MmaPlan] = None):
    """The tensor-core kernel (the run table, up/gate, down, and a merge
    after a split down pass); each weight a (values, scales or None) pair;
    ``plan`` defaults to ``mma_plan``'s."""
    Ct, D = xg.shape
    E, Fd = wi[0].shape[0], wi[0].shape[-1]
    nt = Ct // TILE
    plan = plan or mma_plan(nt, E, bits)
    act = torch.empty((Ct, Fd), dtype=xg.dtype, device=xg.device)
    out = torch.empty_like(xg)
    runs = torch.empty(2 * nt + 2, dtype=torch.int32, device=xg.device)
    part = None
    if plan.split > 1:
        n = plan.split * D * max_runs(nt, E, plan.R) * plan.R * TILE
        part = torch.empty(n, dtype=torch.float32, device=xg.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _mma_library().grouped_mlp_mma(
            xg.data_ptr(), te.data_ptr(), rows_used.data_ptr(), ptr(wi[0]), ptr(wi[1]),
            ptr(wg[0]), ptr(wg[1]), ptr(wo[0]), ptr(wo[1]), act.data_ptr(), out.data_ptr(),
            runs.data_ptr(), ptr(part), nt, E, D, Fd, bits, plan.plan, plan.split, stream)
    if err != 0:
        raise RuntimeError(f"{name}: tensor-core kernel launch failed with CUDA error {err}")
    return out


def launch_capacity_mma(xe, fill, wi, wg, wo, name, n_assign=None,
                        plan: Optional[MmaPlan] = None):
    """The tensor-core kernel over the capacity buffer xe [E, C, D] (the
    capacity run table, up/gate, down, and a merge after a split down pass);
    each weight an (int8 values, f32 scales) pair (kernel 3's format, the
    only one its entry takes); ``plan`` defaults to ``capacity_mma_plan``'s."""
    E, C, D = xe.shape
    Fd = wi[0].shape[-1]
    nt = E * C // TILE
    plan = plan or capacity_mma_plan(E, C, n_assign, 8)
    act = torch.empty((E * C, Fd), dtype=xe.dtype, device=xe.device)
    out = torch.empty_like(xe)
    runs = torch.empty(2 * nt + 2, dtype=torch.int32, device=xe.device)
    part = None
    if plan.split > 1:
        n = plan.split * D * capacity_max_runs(E, C, plan.R, n_assign) * plan.R * TILE
        part = torch.empty(n, dtype=torch.float32, device=xe.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _mma_library().expert_mlp_mma(
            xe.data_ptr(), fill.data_ptr(), ptr(wi[0]), ptr(wi[1]), ptr(wg[0]), ptr(wg[1]),
            ptr(wo[0]), ptr(wo[1]), act.data_ptr(), out.data_ptr(), runs.data_ptr(), ptr(part),
            E, C, D, Fd, n_assign or 0, plan.plan, plan.split, stream)
    if err != 0:
        raise RuntimeError(f"{name}: tensor-core kernel launch failed with CUDA error {err}")
    return out


def capacity_run_table(fill: torch.Tensor, C: int, R: int) -> torch.Tensor:
    """The capacity run table the tensor-core kernel's first launch builds,
    built on the card alone (for checking it against
    ``capacity_run_table_plain``)."""
    if fill.device.type != "cuda":
        return capacity_run_table_plain(fill, C, R)
    nt = fill.shape[0] * C // TILE
    runs = torch.empty(2 * nt + 2, dtype=torch.int32, device=fill.device)
    with torch.cuda.device(fill.device):
        err = _mma_library().expert_mlp_mma_runs(fill.data_ptr(), runs.data_ptr(), fill.shape[0], C,
                                                 R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"capacity_run_table: kernel launch failed with CUDA error {err}")
    return runs


def run_table(te: torch.Tensor, rows_used: torch.Tensor, R: int) -> torch.Tensor:
    """The run table the tensor-core kernel's first launch builds, built on
    the card alone (for checking it against ``run_table_plain``)."""
    if te.device.type != "cuda":
        return run_table_plain(te, rows_used, R)
    nt = te.shape[0]
    runs = torch.empty(2 * nt + 2, dtype=torch.int32, device=te.device)
    with torch.cuda.device(te.device):
        err = _mma_library().grouped_mlp_runs(te.data_ptr(), rows_used.data_ptr(), runs.data_ptr(),
                                              nt, R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"run_table: kernel launch failed with CUDA error {err}")
    return runs


def grouped_mlp_quant(
    xg: torch.Tensor,
    te: torch.Tensor,
    wi: QuantizedArray,
    wg: QuantizedArray,
    wo: QuantizedArray,
    rows_used: torch.Tensor,
) -> torch.Tensor:
    """``grouped_mlp`` over MoQ-quantized experts (kernel 5): int8, or int4
    packed along the contraction axes, with per-output-column scales
    (``check_grouped_quant_compat``)."""
    if account.recorder is not None:
        return account.recorder.kernel("grouped_mlp_quant", grouped_mlp_quant, **locals())
    if xg.device.type == "cpu":
        return grouped_mlp_quant_plain(xg, te, wi, wg, wo, rows_used)
    if xg.device.type != "cuda":
        raise ValueError(f"grouped_mlp_quant: no kernel for device {xg.device}")
    refuse_grad("grouped_mlp_quant", EXPERT_KERNELS, xg, *quant_tensors(wi, wg, wo))
    if not check_grouped_quant_compat(wi, wg, wo):
        raise ValueError(
            "grouped_mlp_quant: the kernel takes int8/int4 per-output-column weights "
            f"(group_size 0) with d_ff a multiple of {BLOCK_F} or less; got bits "
            f"{getattr(wi, 'bits', None)}, group_size {getattr(wi, 'group_size', None)}")
    Ct, D = xg.shape
    E, _, Fd = wi.shape
    for name, t in (("te", te), ("rows_used", rows_used), ("wi", wi.q), ("wg", wg.q),
                    ("wo", wo.q), ("wi.scale", wi.scale), ("wg.scale", wg.scale),
                    ("wo.scale", wo.scale)):
        if t.device != xg.device:
            raise ValueError(f"grouped_mlp_quant: {name} is on {t.device}, xg on {xg.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_mlp_quant: {name} must be contiguous")
    if not xg.is_contiguous() or xg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"grouped_mlp_quant: xg must be contiguous bfloat16 or float32, got {xg.dtype}")
    if te.dtype != torch.int32 or rows_used.dtype != torch.int32 or rows_used.numel() != 1:
        raise TypeError("grouped_mlp_quant: te and rows_used must be int32, rows_used one element")
    if Ct % TILE or te.shape != (Ct // TILE,):
        raise ValueError(f"grouped_mlp_quant: Ct={Ct} must be a multiple of {TILE} with one te entry per tile")
    if wi.shape != (E, D, Fd) or wg.shape != (E, D, Fd) or wo.shape != (E, Fd, D):
        raise ValueError(f"grouped_mlp_quant: weight shapes {wi.shape} {wg.shape} {wo.shape} do not match D={D}")
    for name, w, n in (("wi", wi, Fd), ("wg", wg, Fd), ("wo", wo, D)):
        if w.axis != -2 or w.scale.shape != (E, 1, n) or w.scale.dtype != torch.float32:
            raise ValueError(f"grouped_mlp_quant: {name} must be packed along its contraction "
                             f"axis with float32 scales [E, 1, {n}]")
    variant = kernel_variant(xg.dtype, D, Fd, wi.bits)
    if variant == "mma":
        out = _launch_mma(xg, te, rows_used, (wi.q, wi.scale), (wg.q, wg.scale), (wo.q, wo.scale),
                          wi.bits, "grouped_mlp_quant")
    else:
        lib = _library()
        fn = lib.grouped_mlp_quant_bf16 if xg.dtype == torch.bfloat16 else lib.grouped_mlp_quant_f32
        act = torch.empty((Ct, Fd), dtype=xg.dtype, device=xg.device)
        out = torch.empty_like(xg)
        with torch.cuda.device(xg.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(xg.data_ptr(), te.data_ptr(), rows_used.data_ptr(), wi.q.data_ptr(),
                     wi.scale.data_ptr(), wg.q.data_ptr(), wg.scale.data_ptr(), wo.q.data_ptr(),
                     wo.scale.data_ptr(), act.data_ptr(), out.data_ptr(), Ct // TILE, D, Fd,
                     wi.bits, stream)
        if err != 0:
            raise RuntimeError(f"grouped_mlp_quant: kernel launch failed with CUDA error {err}")
    launches["grouped_mlp_quant"] += 1
    variant_launches[f"grouped_mlp_quant_{variant}"] += 1
    return out
