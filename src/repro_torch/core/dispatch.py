"""Dense mapping-table dispatch (``repro/core/dispatch.py``; DeepSpeed-MoE
§5.4, the paper's optimization over the one-hot einsums).

Tokens are routed with an explicit token -> (expert, slot) table realised as
a scatter into the ``[E, C, D]`` capacity buffer and a gather back: data
movement ``T·K·D`` instead of the einsums' ``T·E·C·D``.  A dropped
assignment goes to a trash row ``E*C`` past the buffer, which is cut off.

``moe_dense`` refuses an ambient mesh of more than one rank, as the JAX
package's does (there the SPMD partitioner mis-partitions its combine
gather; here each rank holds its own slice of the placed expert leaves).
Expert-parallel serving calls ``dispatch_dense`` / ``combine_dense`` in its
own schedules (core/moe_serve.py).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.gating import Gating


def flat_slot(g: Gating, capacity: int, num_experts: int) -> torch.Tensor:
    """[T, K] row of each assignment in the ``[E*C (+1 trash)]`` buffer."""
    slot = g.expert_idx.long() * capacity + g.position.long()
    return torch.where(g.keep, slot, num_experts * capacity)  # dropped -> trash row


def dispatch_dense(x: torch.Tensor, g: Gating, capacity: int, num_experts: int) -> torch.Tensor:
    """x [T, D] -> expert buffers [E, C, D] by a scatter; rows no token
    fills are zero.  Kept slots are unique, so only the trash row is written
    twice (in any order), and it is cut off."""
    T, D = x.shape
    K = g.expert_idx.shape[1]
    dest = flat_slot(g, capacity, num_experts).reshape(-1)  # [T*K]
    src = x.repeat_interleave(K, dim=0) if K > 1 else x
    buf = torch.zeros((num_experts * capacity + 1, D), dtype=x.dtype, device=x.device)
    buf[dest] = src
    return buf[:-1].view(num_experts, capacity, D)


def combine_dense(ye: torch.Tensor, g: Gating, capacity: int, num_experts: int) -> torch.Tensor:
    """ye [E, C, D] -> [T, D]: each token gathers its K expert rows (a zero
    row for a dropped one), weights them in f32 and sums over K."""
    D = ye.shape[-1]
    flat = torch.cat([ye.reshape(num_experts * capacity, D), ye.new_zeros((1, D))])
    gathered = flat[flat_slot(g, capacity, num_experts)]  # [T, K, D]
    y = torch.sum(gathered.float() * g.combine_w.float()[..., None], dim=1)
    return y.to(ye.dtype)


def moe_dense(x: torch.Tensor, g: Gating, capacity: int, num_experts: int,
              expert_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Dense-dispatch MoE: scatter -> ``expert_fn([E, C, D])`` -> gather and
    combine."""
    from repro_torch.parallel.sharding import get_mesh

    mesh = get_mesh()
    if mesh is not None and mesh.size > 1:
        raise ValueError(
            "moe_impl='dense' is numerically unsafe under a multi-device mesh "
            f"({mesh.size} ranks), as in the JAX package: under expert parallelism each rank "
            "holds its own slice of the experts. Use the serving EP schedules "
            "('ep_serve'/'ep_grouped' via cfg.ep_mesh), or 'einsum'/'grouped' for replicated "
            "execution.")
    xe = dispatch_dense(x, g, capacity, num_experts)
    return combine_dense(expert_fn(xe), g, capacity, num_experts)
