"""Grouped "dropless" MoE dispatch (``repro/core/dispatch_grouped.py``,
MegaBlocks-style).

Assignments are sorted by expert (stable, token-major priority kept), each
expert's group is padded only up to the next multiple of the token tile, and
the tokens land in one ``[Ct, D]`` buffer whose size
``Ct = round_down(T*K + E*(tile-1), tile)`` is the worst case over all
routings.  ``tile_expert [Ct/tile]`` names the expert of each tile, which is
what the grouped kernel walks.  Trailing tiles past the used rows belong to
no expert (clamped to E-1, rows all zero); ``rows_used`` tells the kernel
where they start, as a device scalar, so it can skip them without a host
sync.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.core.gating import Gating, count_ids

# Token-tile granularity of the grouped buffer; the kernel's tile.
GROUPED_TILE = 8


def grouped_rows(num_tokens: int, top_k: int, num_experts: int, tile: int = GROUPED_TILE) -> int:
    """Static row count of the grouped buffer (worst-case tile padding)."""
    tk = num_tokens * top_k
    return (tk + num_experts * (tile - 1)) // tile * tile


class GroupedLayout(NamedTuple):
    """dst:         [T*K] int64 — grouped-buffer row of each (token, k) slot
    tile_expert: [Ct/tile] int32 — expert id owning each token tile
    counts:      [E] int32 — real (un-padded) assignments per expert
    rows_used:   [1] int32 — rows of real groups (``sum(padded counts)``);
                 tiles at or past it hold no token
    """

    dst: torch.Tensor
    tile_expert: torch.Tensor
    counts: torch.Tensor
    rows_used: torch.Tensor


def grouped_layout(g: Gating, num_experts: int, *, tile: int = GROUPED_TILE) -> GroupedLayout:
    T, K = g.expert_idx.shape
    TK = T * K
    dev = g.expert_idx.device
    flat_e = g.expert_idx.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = count_ids(flat_e, num_experts)
    padded = (counts + tile - 1) // tile * tile
    group_start = torch.searchsorted(sorted_e, torch.arange(num_experts, device=dev), right=False)
    rank_sorted = torch.arange(TK, device=dev) - group_start[sorted_e]
    bounds = torch.cumsum(padded, dim=0)  # [E]
    starts = bounds - padded
    dst = torch.empty(TK, dtype=torch.long, device=dev)
    dst[order] = starts[sorted_e] + rank_sorted
    nt = grouped_rows(T, K, num_experts, tile) // tile
    tile_start = torch.arange(nt, device=dev) * tile
    tile_expert = torch.searchsorted(bounds, tile_start, right=True).clamp_(0, num_experts - 1)
    return GroupedLayout(
        dst=dst,
        tile_expert=tile_expert.to(torch.int32),
        counts=counts.to(torch.int32),
        rows_used=bounds[-1:].to(torch.int32),
    )


def scatter_grouped(x: torch.Tensor, g: Gating, num_experts: int, *,
                    tile: int = GROUPED_TILE) -> Tuple[GroupedLayout, torch.Tensor]:
    """x [T, D] and dropless gating -> (layout, xg [Ct, D]): each (token, k)
    slot's row of x at its grouped-buffer row, the other rows zero."""
    T, D = x.shape
    K = g.expert_idx.shape[1]
    layout = grouped_layout(g, num_experts, tile=tile)
    Ct = layout.tile_expert.shape[0] * tile
    token = torch.arange(T * K, device=x.device) // K
    xg = torch.zeros((Ct, D), dtype=x.dtype, device=x.device)
    xg[layout.dst] = x[token]
    return layout, xg


def combine_grouped(yg: torch.Tensor, layout: GroupedLayout, g: Gating, dtype) -> torch.Tensor:
    """yg [Ct, D] -> y [T, D] in ``dtype``: each token gathers its K rows and
    sums them, weighted, in slot order in f32 — deterministic on the card,
    where ``index_add_`` would run in atomics' order (the JAX package
    scatter-adds in f32)."""
    T, K = g.expert_idx.shape
    rows = yg[layout.dst].view(T, K, yg.shape[-1]).float()
    w = g.combine_w.float()
    y = w[:, 0, None] * rows[:, 0]
    for k in range(1, K):
        y = y + w[:, k, None] * rows[:, k]
    return y.to(dtype)


def moe_grouped(
    x: torch.Tensor,
    g: Gating,
    num_experts: int,
    expert_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    tile: int = GROUPED_TILE,
) -> torch.Tensor:
    """x: [T, D]; ``g`` must be dropless gating (``capacity = T*K``).
    ``expert_fn(xg [Ct, D], tile_expert, rows_used) -> [Ct, D]``."""
    layout, xg = scatter_grouped(x, g, num_experts, tile=tile)
    yg = expert_fn(xg, layout.tile_expert, layout.rows_used)
    return combine_grouped(yg, layout, g, x.dtype)
