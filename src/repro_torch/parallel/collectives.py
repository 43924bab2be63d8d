"""Collectives of the expert-parallel schedules (``repro/parallel/collectives.py``;
DeepSpeed-MoE §5.3) on ``torch.distributed``, differentiable.

All-to-all schedules over the expert dimension of an ``[E, C, D]`` dispatch
buffer (E = total experts, C = per-source capacity):

  * ``flat_all_to_all``: one exchange over the whole EP group;
  * ``hierarchical_all_to_all``: the paper's two hops (Fig. 8), an exchange
    over the inner axis, a layout transform, then one over the outer axis;
    O(Go + Gi) serialized hops instead of O(Go * Gi).

plus ``all_gather``, ``psum_scatter`` (a reduce-scatter), ``psum``,
``pmean`` and ``pvary``.

JAX's ``all_to_all(x, axes, split_axis, concat_axis, tiled=True)`` becomes
``all_to_all``: ``split_axis`` is cut into P chunks moved to the front (chunk
j goes to rank j of the group), one ``dist.all_to_all_single`` exchanges
them, and the P received chunks are concatenated along ``concat_axis`` in
source-rank order, which is JAX's order: a multi-axis group's ranks are
outer-major (``sharding.EpMesh``).

**Gradients** (expert-parallel training).  Under grad each collective is a
``torch.autograd.Function`` whose backward is the transpose that JAX's
``shard_map`` gives it:

  * ``all_to_all`` -> the inverse ``all_to_all`` (split and concat axes
    swapped); ``hierarchical_all_to_all`` <-> ``hierarchical_all_to_all_back``;
  * ``all_gather`` -> ``psum_scatter``, and ``psum_scatter`` -> ``all_gather``;
  * ``psum`` -> the identity and ``pmean`` -> the cotangent over P: their
    outputs are replicated over the group, and JAX's varying-axes rules give
    a replicated value a replicated cotangent (the full cotangent on every
    rank, not a share of it);
  * ``pvary`` (no forward work) -> ``psum``: where a value replicated over
    an axis meets a leaf sharded over it (the received tokens and the
    expert slices over ``model``), each rank's cotangent is a partial one.

The convention this fixes: every rank backpropagates its share ``l_r`` of
the global loss, ``l_r = CE(rank's rows) * T_loc / T + aux_coef * aux``: the
token mean over the global batch split by rows, and the aux loss whole
(it is built from ``pmean``'d statistics, the same on every rank).  Ranks
that differ only along ``model`` hold the same rows and the same ``l_r``.
Then the gradient of the global loss is, for a leaf replicated over the
batch axes (attention, norms, embeddings, the router, the shared expert),
the SUM over the batch axes of the ranks' gradients (the same on every
``model`` rank; ZeRO-1's reduce-scatter takes it, ``training/optimizer.py``),
and for an expert shard its rank's own gradient, complete: every rank's
tokens reach it through the all-to-all's backward (summed over any batch
axis the experts do not shard, ``pod`` without the two-hop exchange).

On a ``gloo`` group a CUDA tensor is staged through host memory (copied to
the CPU, exchanged, copied back) and its bytes are counted in ``staged``;
that follows from the backend the caller initialized, never from a failure.
NCCL takes device tensors as they are.  The forward of every collective is
the same computation with or without grad.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import EpMesh
from repro_torch.kernels import account

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




# ---------------------------------------------------------------------------
# The forward computations
# ---------------------------------------------------------------------------


def _all_to_all(x, mesh, axes, split_axis, concat_axis):
    if account.recorder is not None:
        return account.recorder.collective("all_to_all", _all_to_all, **locals())
    group = group_of(mesh, axes)
    P = mesh.axes_size(axes)
    if x.shape[split_axis] % P:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} is not a multiple of {P}")
    chunks = x.unflatten(split_axis, (P, x.shape[split_axis] // P)).movedim(split_axis, 0)
    chunks = chunks.contiguous()
    recv = _run(_a2a, torch.empty_like(chunks), chunks, group)  # [P sources, *chunk]
    # the source dim just before concat_axis, then merged with it source-major
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


def _all_gather(x, mesh, axes):
    if account.recorder is not None:
        return account.recorder.collective("all_gather", _all_gather, **locals())
    group = group_of(mesh, axes)
    P = mesh.axes_size(axes)
    x = x.contiguous()
    out = torch.empty((P * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    return _run(_gather, out, x, group)


def _psum(x, mesh, axes):
    if account.recorder is not None:
        return account.recorder.collective("psum", _psum, **locals())
    group = group_of(mesh, axes)
    x = x.contiguous()
    return _run(_sum, torch.empty_like(x), x, group)


def _psum_scatter(x, mesh, axes):
    """NCCL reduce-scatters; gloo exchanges the chunks (staged for a CUDA
    tensor) and adds them where x lies, in source-rank order."""
    if account.recorder is not None:
        return account.recorder.collective("psum_scatter", _psum_scatter, **locals())
    group = group_of(mesh, axes)
    P = mesh.axes_size(axes)
    if x.shape[0] % P:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(x.shape)} is not a multiple of {P}")
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((x.shape[0] // P, *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    recv = _run(_a2a, torch.empty_like(x), x, group)
    return recv.view(P, x.shape[0] // P, *x.shape[1:]).sum(0)


def _hierarchical(x, mesh, inner_axis, outer_axis):
    Go = mesh.axis_size(outer_axis)
    Gi = mesh.axis_size(inner_axis)
    E, C, D = x.shape
    E_loc = E // (Go * Gi)
    # [Go', Gi', E_loc, C, D]: destination-indexed blocks
    xv = x.reshape(Go, Gi, E_loc, C, D)
    # hop 1, within the inner axis on the Gi' dim: member i of each inner
    # group then holds the blocks for inner rank i of every outer group
    s1 = _all_to_all(xv, mesh, inner_axis, 1, 3)
    # [Go', 1, E_loc, Gi_src*C, D]; the layout transform is this reshape
    s1 = s1.reshape(Go, E_loc, Gi * C, D)
    # hop 2, across the outer axis
    s2 = _all_to_all(s1, mesh, outer_axis, 0, 2)
    return s2.reshape(E_loc, Go * Gi * C, D)


def _hierarchical_back(y, mesh, inner_axis, outer_axis):
    Go = mesh.axis_size(outer_axis)
    Gi = mesh.axis_size(inner_axis)
    E_loc, PC, D = y.shape
    C = PC // (Go * Gi)
    yv = y.reshape(1, E_loc, Go, Gi * C, D)
    s1 = _all_to_all(yv, mesh, outer_axis, 2, 0)
    s1 = s1.reshape(Go, E_loc, Gi, C, D)
    s2 = _all_to_all(s1, mesh, inner_axis, 2, 1)
    return s2.reshape(Go * Gi * E_loc, C, D)


# ---------------------------------------------------------------------------
# Their transposes (autograd)
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_axis, concat_axis):
        ctx.args = (mesh, axes, split_axis, concat_axis)
        return _all_to_all(x, mesh, axes, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_axis, concat_axis = ctx.args
        return _all_to_all(g, mesh, axes, concat_axis, split_axis), None, None, None, None


class _Hierarchical(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, inner_axis, outer_axis, back):
        ctx.args = (mesh, inner_axis, outer_axis, back)
        return (_hierarchical_back if back else _hierarchical)(x, mesh, inner_axis, outer_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, inner_axis, outer_axis, back = ctx.args
        fn = _hierarchical if back else _hierarchical_back
        return fn(g.contiguous(), mesh, inner_axis, outer_axis), None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _all_gather(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, *ctx.args), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _psum_scatter(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None  # a replicated cotangent passes as it is


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, *ctx.args), None, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def all_to_all(x: torch.Tensor, mesh: EpMesh, axes: Axes, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` over the group of ``axes``."""
    if _grad(x):
        return _AllToAll.apply(x, mesh, axes, split_axis, concat_axis)
    return _all_to_all(x, mesh, axes, split_axis, concat_axis)


def all_gather(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """JAX's tiled ``all_gather`` along dim 0: the ranks' ``x`` concatenated
    in group-rank order."""
    if _grad(x):
        return _AllGather.apply(x, mesh, axes)
    return _all_gather(x, mesh, axes)


def psum_scatter(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """JAX's tiled ``psum_scatter`` along dim 0: rank i of the group gets the
    group's sum of chunk i (of P)."""
    if _grad(x):
        return _PsumScatter.apply(x, mesh, axes)
    return _psum_scatter(x, mesh, axes)


def psum(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """The elementwise sum over the group (a new tensor)."""
    if _grad(x):
        return _Psum.apply(x, mesh, axes)
    return _psum(x, mesh, axes)


def pmean(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """The elementwise mean over the group: ``psum / P``, as JAX's
    ``pmean``."""
    return psum(x, mesh, axes) / mesh.axes_size(axes)


def pvary(x: torch.Tensor, mesh: EpMesh, axes: Axes) -> torch.Tensor:
    """``x`` itself, marked as meeting values that vary over ``axes``: its
    gradient is the sum over the group of the ranks' gradients."""
    if _grad(x):
        return _Pvary.apply(x, mesh, axes)
    return x


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
    if _grad(x):
        return _Hierarchical.apply(x, mesh, inner_axis, outer_axis, False)
    return _hierarchical(x, mesh, inner_axis, outer_axis)


def hierarchical_all_to_all_back(y: torch.Tensor, mesh: EpMesh, inner_axis: str,
                                 outer_axis: str) -> torch.Tensor:
    """Inverse of ``hierarchical_all_to_all``: [E_loc, Go*Gi*C, D] -> [E, C, D]."""
    if _grad(y):
        return _Hierarchical.apply(y, mesh, inner_axis, outer_axis, True)
    return _hierarchical_back(y, mesh, inner_axis, outer_axis)
