"""One-hot einsum dispatch (``repro/core/dispatch_einsum.py``): the baseline
that DeepSpeed-MoE §5.4 optimises away, kept because its latency claims are
measured against it.  Routing is expressed as einsums with ``[T, E, C]``
one-hot dispatch and combine tensors, ``T·E·C·D`` work each way.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.gating import Gating


def dispatch_combine_tensors(g: Gating, capacity: int):
    """The classic [T, E, C] dispatch (bool) and combine (f32) tensors."""
    E = g.probs.shape[-1]
    eo = F.one_hot(g.expert_idx.long(), E).float()  # [T, K, E]
    po = F.one_hot(g.position.long(), capacity).float()  # [T, K, C]
    keep = g.keep.float()[..., None, None]
    dc = torch.einsum("tke,tkc->tkec", eo, po) * keep  # [T, K, E, C]
    combine = torch.sum(dc * g.combine_w.float()[..., None, None], dim=1)  # [T, E, C]
    dispatch = torch.sum(dc, dim=1) > 0  # [T, E, C]
    return dispatch, combine


def moe_einsum(x: torch.Tensor, g: Gating, capacity: int,
               expert_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """x [T, D] -> [T, D]: dispatch einsum in f32 cast to x's type, the
    experts, combine einsum in f32."""
    dispatch, combine = dispatch_combine_tensors(g, capacity)
    xe = torch.einsum("td,tec->ecd", x.float(), dispatch.float()).to(x.dtype)
    ye = expert_fn(xe)  # [E, C, D]
    y = torch.einsum("ecd,tec->td", ye.float(), combine)
    return y.to(x.dtype)


def moe_einsum_dropless(x: torch.Tensor, g: Gating,
                        expert_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Dropless oracle for the grouped path: the same einsums with capacity
    ``T*K`` (``g`` gated with that capacity, every assignment kept).  A
    correctness reference, never a serving path."""
    T, K = g.expert_idx.shape
    return moe_einsum(x, g, T * K, expert_fn)
