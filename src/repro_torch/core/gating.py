"""Top-k expert gating (``repro/core/gating.py``; DeepSpeed-MoE §3.1, §5.4).

router logits -> f32 softmax -> top-k expert ids -> position of each
assignment in its expert's buffer (token-major priority) -> combine weights.
Tie order follows ``jax.lax.top_k``: equal probabilities go to the lower
expert id, which ``torch.topk`` does not promise, so top-k is an iterative
masked argmax (``argmax`` returns the first maximum).  Also the trainer's
parts: ``load_balance_stats``, ``RoutingStats`` / ``routing_stats`` /
``routing_to_host`` / ``summarize_routing`` (per-layer routing telemetry) and ``router_z_loss``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Gating(NamedTuple):
    """T = tokens, K = top_k.

    expert_idx:  [T, K] int32 — chosen expert per (token, slot-k)
    combine_w:   [T, K] f32   — gate probability (0 where dropped)
    position:    [T, K] int32 — position within the expert's capacity buffer
    keep:        [T, K] bool  — False if dropped by capacity
    probs:       [T, E] f32   — full softmax (for aux loss)
    """

    expert_idx: torch.Tensor
    combine_w: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor


def expert_capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Tokens each expert can accept (padded to a multiple of 8 ≥ 8)."""
    c = int(capacity_factor * num_tokens * top_k / num_experts)
    c = max(c, 8)
    return ((c + 7) // 8) * 8


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, minlength=n)`` for ids in ``[0, n)``, as an int64
    scatter-add: exact in any order, and unlike ``bincount`` on the card it
    needs no host sync to size its output."""
    ids = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))


def _top_k(probs: torch.Tensor, k: int):
    """Values and indices of the k largest entries per row, descending, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    if k == 1:
        idx = torch.argmax(probs, dim=-1, keepdim=True)
        return torch.gather(probs, -1, idx), idx
    masked = probs.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(masked, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idxs.append(i)
        masked.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _positions_sort(flat_expert: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each slot within its expert's run, by a stable argsort (the
    JAX package's ``_positions_sort``; its ``cumsum`` method gives the same
    ranks)."""
    TK = flat_expert.shape[0]
    order = torch.argsort(flat_expert, stable=True)
    sorted_e = flat_expert[order]
    group_start = torch.searchsorted(sorted_e, torch.arange(E, device=flat_expert.device), right=False)
    rank_sorted = torch.arange(TK, device=flat_expert.device) - group_start[sorted_e]
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    return pos


def top_k_gating(logits: torch.Tensor, top_k: int, capacity: int, *, normalize: bool = True) -> Gating:
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_w, expert_idx = _top_k(probs, top_k)
    if normalize and top_k > 1:
        gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)
    flat_expert = expert_idx.reshape(-1)  # token-major: slot t*K + k
    position = _positions_sort(flat_expert, E).view(T, top_k)
    keep = position < capacity
    combine_w = torch.where(keep, gate_w, torch.zeros((), device=gate_w.device))
    position = torch.where(keep, position, torch.full((), capacity - 1, device=position.device))
    return Gating(expert_idx.to(torch.int32), combine_w, position.to(torch.int32), keep, probs)


def load_balance_stats(probs: torch.Tensor, expert_idx: torch.Tensor, num_experts: int):
    """Per-expert (f_e, P_e): the fraction of primary (k=0) assignments (no
    gradient: counts) and the mean router probability."""
    T = probs.shape[0]
    f = count_ids(expert_idx[:, 0], num_experts).float() / T
    p = torch.mean(probs, dim=0)
    return f, p


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-Transformer auxiliary loss ``E * sum_e f_e * P_e``: f counts
    primary (k=0) assignments, P is the mean router probability."""
    f, p = load_balance_stats(probs, expert_idx, num_experts)
    return num_experts * torch.sum(f * p)


class RoutingStats(NamedTuple):
    """Routing telemetry of one MoE layer (the JAX package's leaves and
    shapes): tokens_per_expert [E] int32 (kept assignments over every k),
    dropped_frac [] (assignments dropped by capacity), entropy [] (mean
    router entropy, nats), imbalance [] (E * sum f * P; 1 = balanced), f [E],
    p [E] (``load_balance_stats``)."""

    tokens_per_expert: torch.Tensor
    dropped_frac: torch.Tensor
    entropy: torch.Tensor
    imbalance: torch.Tensor
    f: torch.Tensor
    p: torch.Tensor


@torch.no_grad()
def routing_stats(g: Gating, num_experts: int) -> RoutingStats:
    """RoutingStats of one layer's gating decision; ``f`` / ``p`` are exactly
    ``load_balance_stats``, so telemetry cannot drift from the aux loss.
    No gradient flows through it."""
    f, p = load_balance_stats(g.probs, g.expert_idx, num_experts)
    kept = torch.where(g.keep, g.expert_idx.long(), num_experts)  # dropped -> bucket E
    tokens_per_expert = count_ids(kept, num_experts + 1)[:num_experts]
    dropped = 1.0 - torch.mean(g.keep.float())
    entropy = -torch.mean(torch.sum(g.probs * torch.log(g.probs + 1e-9), dim=-1))
    imbalance = num_experts * torch.sum(f * p)
    return RoutingStats(tokens_per_expert.to(torch.int32), dropped, entropy, imbalance, f, p)


def stack_stats(per_repeat) -> RoutingStats:
    """One segment position's RoutingStats of each repeat -> leaves stacked
    ``[repeats, ...]``, as JAX's scan stacks them."""
    return RoutingStats(*(torch.stack(leaves) for leaves in zip(*per_repeat)))


def routing_to_host(stats_tree) -> dict:
    """The routing-stats tree with every leaf a numpy array, in ONE
    device-to-host copy: the leaves are flattened into one f64 vector
    (exact for the f32 statistics and the int32 counts) and split back on
    the host.  What the engines hand ``summarize_routing`` each step."""
    keys = [(s, p) for s in sorted(stats_tree) for p in sorted(stats_tree[s])]
    leaves = [t for s, p in keys for t in stats_tree[s][p]]
    if not leaves:
        return {}
    flat = torch.cat([t.detach().reshape(-1).double() for t in leaves]).cpu().numpy()
    out, o = {}, 0
    for s, p in keys:
        parts = []
        for t in stats_tree[s][p]:
            n = t.numel()
            a = flat[o : o + n].reshape(tuple(t.shape))
            parts.append(a.astype(np.float32 if t.is_floating_point() else np.int32))
            o += n
        out.setdefault(s, {})[p] = RoutingStats(*parts)
    return out


def summarize_routing(stats_tree) -> dict:
    """Host-side per-layer aggregation of ``forward(..., return_routing=True)``'s
    tree ``{seg: {pos: RoutingStats with [repeats, ...] leaves}}`` (the JAX
    package's ``summarize_routing``): overall means across MoE layers and a
    per-layer breakdown keyed ``"{seg}/{pos}[repeat]"``, plain floats and
    lists."""
    host = lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    per_layer = {}
    for seg in sorted(stats_tree):
        for pos in sorted(stats_tree[seg]):
            st = RoutingStats(*(host(x) for x in stats_tree[seg][pos]))
            for r in range(st.dropped_frac.shape[0]):
                tpe = st.tokens_per_expert[r]
                per_layer[f"{seg}/{pos}[{r}]"] = {
                    "dropped_frac": float(st.dropped_frac[r]),
                    "entropy": float(st.entropy[r]),
                    "imbalance": float(st.imbalance[r]),
                    "tokens_per_expert": tpe.tolist(),
                    "max_expert_load": float(tpe.max() / max(tpe.sum(), 1)),
                }
    n = max(len(per_layer), 1)
    return {
        "moe_layers": len(per_layer),
        "dropped_frac": sum(v["dropped_frac"] for v in per_layer.values()) / n,
        "entropy": sum(v["entropy"] for v in per_layer.values()) / n,
        "imbalance": sum(v["imbalance"] for v in per_layer.values()) / n,
        "per_layer": per_layer,
    }


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """Router z-loss (ST-MoE): the mean squared log-partition of the f32
    router logits."""
    z = torch.logsumexp(logits.float(), dim=-1)
    return torch.mean(z ** 2)
