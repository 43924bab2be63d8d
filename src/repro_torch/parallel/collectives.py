"""Collectives of the expert-parallel schedules (``repro/parallel/collectives.py``;
DeepSpeed-MoE §5.3) on ``torch.distributed``.

All-to-all schedules over the expert dimension of an ``[E, C, D]`` dispatch
buffer (E = total experts, C = per-source capacity):

  * ``flat_all_to_all``: one exchange over the whole EP group;
  * ``hierarchical_all_to_all``: the paper's two hops (Fig. 8), an exchange
    over the inner axis, a layout transform, then one over the outer axis;
    O(Go + Gi) serialized hops instead of O(Go * Gi).

plus the ``all_gather``, ``psum`` and ``pmean`` the serving schedules use.

JAX's ``all_to_all(x, axes, split_axis, concat_axis, tiled=True)`` becomes
``all_to_all``: ``split_axis`` is cut into P chunks moved to the front (chunk
j goes to rank j of the group), one ``dist.all_to_all_single`` exchanges
them, and the P received chunks are concatenated along ``concat_axis`` in
source-rank order, which is JAX's order: a multi-axis group's ranks are
outer-major (``sharding.EpMesh``).

On a ``gloo`` group a CUDA tensor is staged through host memory (copied to
the CPU, exchanged, copied back) and its bytes are counted in ``staged``;
that follows from the backend the caller initialized, never from a failure.
NCCL takes device tensors as they are.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import EpMesh

Axes = Union[str, Sequence[str]]

# host-staged traffic of gloo collectives over CUDA tensors: bytes copied to
# the host and back, and the collectives that staged
staged = {"bytes": 0, "calls": 0}


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def group_of(mesh: EpMesh, axes: Axes):
    """The process group over ``axes``: one axis, or every axis of the mesh
    in its order (outer-major ranks)."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.axis_groups[axes[0]]
    if axes == tuple(mesh.axis_names):
        return mesh.group
    raise ValueError(f"collective over {axes}: expected one axis or all of {mesh.axis_names}")


def _staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _run(op, out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    """``op(out, x, group)`` on the tensors' device, or on host copies of
    them for a gloo group over CUDA tensors."""
    if not _staged(group, x):
        op(out, x, group)
        return out
    host_in = x.cpu()
    host_out = torch.empty(out.shape, dtype=out.dtype)
    op(host_out, host_in, group)
    staged["bytes"] += host_in.numel() * host_in.element_size() \
        + host_out.numel() * host_out.element_size()
    staged["calls"] += 1
    return out.copy_(host_out)


def _a2a(out, x, group):
    dist.all_to_all_single(out, x, group=group)


def _gather(out, x, group):
    # views of ``out``, one a rank, which the collective fills in place
    dist.all_gather(list(out.chunk(dist.get_world_size(group))), x, group=group)


def _sum(out, x, group):
    out.copy_(x)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)


def all_to_all(x: torch.Tensor, mesh: EpMesh, axes: Axes, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` over the group of ``axes``."""
    group = group_of(mesh, axes)
    P = mesh.axes_size(axes)
    if x.shape[split_axis] % P:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} is not a multiple of {P}")
    chunks = x.unflatten(split_axis, (P, x.shape[split_axis] // P)).movedim(split_axis, 0)
    chunks = chunks.contiguous()
    recv = _run(_a2a, torch.empty_like(chunks), chunks, group)  # [P sources, *chunk]
    # the source dim just before concat_axis, then merged with it source-major
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


def all_gather(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """JAX's tiled ``all_gather`` along dim 0: the ranks' ``x`` concatenated
    in group-rank order."""
    group = group_of(mesh, axes)
    P = mesh.axes_size(axes)
    x = x.contiguous()
    out = torch.empty((P * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    return _run(_gather, out, x, group)


def psum(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """The elementwise sum over the group (a new tensor)."""
    group = group_of(mesh, axes)
    x = x.contiguous()
    return _run(_sum, torch.empty_like(x), x, group)


def pmean(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """The elementwise mean over the group: ``psum / P``, as JAX's
    ``pmean``."""
    return psum(x, mesh, axes) / mesh.axes_size(axes)


def flat_all_to_all(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """x: [E, C, D] with E == P * E_loc -> [E_loc, P*C, D]."""
    return all_to_all(x, mesh, axes, split_axis=0, concat_axis=1)


def flat_all_to_all_back(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """Inverse of ``flat_all_to_all``: [E_loc, P*C, D] -> [E, C, D]."""
    return all_to_all(x, mesh, axes, split_axis=1, concat_axis=0)


def hierarchical_all_to_all(x: torch.Tensor, mesh: EpMesh, inner_axis: str,
                            outer_axis: str) -> torch.Tensor:
    """The two hops of Fig. 8.  x: [E, C, D], E = Go * Gi * E_loc laid out
    outer-major.  Returns [E_loc, Go*Gi*C, D], the same as
    ``flat_all_to_all`` over (outer, inner)."""
    Go = mesh.axis_size(outer_axis)
    Gi = mesh.axis_size(inner_axis)
    E, C, D = x.shape
    E_loc = E // (Go * Gi)
    # [Go', Gi', E_loc, C, D]: destination-indexed blocks
    xv = x.reshape(Go, Gi, E_loc, C, D)
    # hop 1, within the inner axis on the Gi' dim: member i of each inner
    # group then holds the blocks for inner rank i of every outer group
    s1 = all_to_all(xv, mesh, inner_axis, split_axis=1, concat_axis=3)
    # [Go', 1, E_loc, Gi_src*C, D]; the layout transform is this reshape
    s1 = s1.reshape(Go, E_loc, Gi * C, D)
    # hop 2, across the outer axis
    s2 = all_to_all(s1, mesh, outer_axis, split_axis=0, concat_axis=2)
    return s2.reshape(E_loc, Go * Gi * C, D)


def hierarchical_all_to_all_back(y: torch.Tensor, mesh: EpMesh, inner_axis: str,
                                 outer_axis: str) -> torch.Tensor:
    """Inverse of ``hierarchical_all_to_all``: [E_loc, Go*Gi*C, D] -> [E, C, D]."""
    Go = mesh.axis_size(outer_axis)
    Gi = mesh.axis_size(inner_axis)
    E_loc, PC, D = y.shape
    C = PC // (Go * Gi)
    yv = y.reshape(1, E_loc, Go, Gi * C, D)
    s1 = all_to_all(yv, mesh, outer_axis, split_axis=2, concat_axis=0)
    s1 = s1.reshape(Go, E_loc, Gi, C, D)
    s2 = all_to_all(s1, mesh, inner_axis, split_axis=2, concat_axis=1)
    return s2.reshape(Go * Gi * E_loc, C, D)
