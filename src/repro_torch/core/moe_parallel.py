"""Expert-parallel MoE layer of training (``repro/core/moe_parallel.py``;
DeepSpeed-MoE §5.2-5.3) on ``torch.distributed``, one process per rank.

JAX runs ``moe_layer_ep`` as one program under ``shard_map``; the port runs
the per-device body on every rank, on the rank's own rows of the batch.
Layout, mesh ``(pod, data, model)`` or any part of it:

  tokens  x    : this rank's rows, over the batch axes ``('pod', 'data')``,
                 the same rows on every ``model`` rank
  router       : replicated
  expert wi/wo : ``[E_loc, D, F_loc]`` / ``[E_loc, F_loc, D]``: experts over
                 ``data`` (``('pod', 'data')`` under ``ep_pod``), d_ff
                 sliced over ``model`` (expert-slicing), as
                 ``parallel/params.py::shard_params(mode="train")`` places
                 them
  y            : this rank's rows

Two schedules, chosen as JAX chooses them (``t_loc * K <= E``: few tokens a
shard take the all-gather one):

  * **a2a** (``_moe_body``): the shard's gating at the shard's capacity
    (kernel 1, 1b under grad), the dense mapping-table dispatch, the
    exchange over ``data`` (the two-hop one of Fig. 8 under ``ep_pod``), the
    rank's experts over ``[E_loc, ep * cap, D]`` (SwiGLU: kernel 2 with 2b,
    every row computed; GELU / ReLU: ``torch.bmm``, as JAX's einsums), the
    sum over ``model`` that completes the slicing, the exchange back, the
    combine, and the aux loss from the ``pmean``'d (f, P).  Capacity is per
    shard: the drops are the shard's, as in JAX.
  * **all-gather** (``_moe_body_allgather``): the tokens gathered over
    ``data``, gated together, the rank's experts over its assignments, the
    sum over ``model``, the combine, and a reduce-scatter of the output.

Gradients follow ``parallel/collectives.py``'s convention: each rank
backpropagates its share of the loss and the aux loss whole; the received
tokens meet the ``model``-sliced experts through ``pvary``, so their
gradient sums the slices'.  ``_bwd_cast`` pins the cotangents at the
exchanges to the activations' type under ``models/transformer.BF16_BWD``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import FFNSpec, ModelConfig
from repro_torch.core.dispatch import combine_dense, dispatch_dense
from repro_torch.core.gating import expert_capacity, load_balance_loss, load_balance_stats
from repro_torch.kernels.moe_gating import gating
from repro_torch.models.modules import act_fn
from repro_torch.parallel import collectives as col
from repro_torch.parallel.params import ep_rank, expert_axes
from repro_torch.parallel.sharding import EpMesh, get_mesh, get_rules

EP_AXIS = "data"
TP_AXIS = "model"

# Cross-pod expert parallelism (paper §5.3, Fig. 8) is the rules' choice:
# where ``expert`` places the experts over ('pod', 'data')
# (``parallel.sharding.RULESETS["ep_pod"]``) the layer takes the two-hop
# exchange; JAX's ``EP_POD`` flag has no counterpart, so the placement and
# the exchange cannot disagree.


def _bwd_cast(x: torch.Tensor) -> torch.Tensor:
    """Under the bf16-backward switch, the cotangent at an exchange is cast
    to the activation's type (``combine_dense`` does f32 math, whose
    cotangents would otherwise cross the sum over ``model`` and both
    exchanges at 4 bytes a value)."""
    from repro_torch.models.modules import grad_cast
    from repro_torch.models.transformer import BF16_BWD

    return grad_cast(x) if BF16_BWD[0] else x


def _batch_axes(mesh: EpMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", EP_AXIS) if a in mesh.axis_names)


def _experts(spec: FFNSpec, mesh: EpMesh, xe: torch.Tensor, wi, wg, wo,
             fill: Optional[torch.Tensor]) -> torch.Tensor:
    """The rank's experts over xe [E_loc, C, D] (SwiGLU through kernel 2, its
    backward 2b), summed over ``model`` where the experts are sliced."""
    from repro_torch.kernels.expert_mlp import expert_mlp

    sliced = TP_AXIS in mesh.axis_names and mesh.axis_size(TP_AXIS) > 1
    if sliced:
        xe = col.pvary(xe, mesh, TP_AXIS)
    if spec.act == "swiglu":
        out = expert_mlp(xe, wi, wg, wo, fill)
    else:
        out = torch.bmm(act_fn(spec.act)(torch.bmm(xe, wi)), wo)
    if sliced:
        out = col.psum(out, mesh, TP_AXIS)
    return out


def _moe_body(spec: FFNSpec, mesh: EpMesh, hier: bool, x_loc: torch.Tensor, router, wi, wg, wo):
    B_loc, S, D = x_loc.shape
    E, K = spec.num_experts, spec.top_k
    T_loc = B_loc * S
    cap = expert_capacity(T_loc, E, K, spec.capacity_factor)

    xs = _bwd_cast(x_loc.reshape(T_loc, D))
    logits = xs.float() @ router
    g, _ = gating(logits, K, cap)
    # local scatter into [E, cap, D] buffers (the dense mapping table, §5.4)
    buf = dispatch_dense(xs, g, cap, E)
    if hier:  # intra-pod ('data') hop, then inter-pod
        recv = col.hierarchical_all_to_all(buf, mesh, EP_AXIS, "pod")
    else:  # the coordinated exchange over the EP axis only (groups of p / L)
        recv = col.flat_all_to_all(buf, mesh, EP_AXIS)
    recv = _bwd_cast(recv)
    # recv [E_loc, ep * cap, D]: each source's block fills a prefix of its
    # cap rows, so no per-expert fill bounds the rows; every row is computed
    out = _bwd_cast(_experts(spec, mesh, recv, wi, wg, wo, None))
    if hier:
        back = col.hierarchical_all_to_all_back(out, mesh, EP_AXIS, "pod")
    else:
        back = col.flat_all_to_all_back(out, mesh, EP_AXIS)
    back = _bwd_cast(back)
    y = combine_dense(back, g, cap, E).reshape(B_loc, S, D)
    # the global batch's load balance: pmean the per-expert stats (linear in
    # the tokens) over the batch axes, then the product (the one-device
    # loss; per-shard losses averaged would not be)
    f, p = load_balance_stats(g.probs, g.expert_idx, E)
    axes = _batch_axes(mesh)
    f = col.pmean(f, mesh, axes)
    p = col.pmean(p, mesh, axes)
    return y, E * torch.sum(f * p)


def _moe_body_allgather(spec: FFNSpec, mesh: EpMesh, x_loc: torch.Tensor, router, wi, wg, wo):
    """Few tokens a shard: gather them over the EP axis, run the rank's
    experts on the full token set, reduce-scatter the combined output
    (traffic O(tokens * D) a layer instead of O(E * cap * D))."""
    B_loc, S, D = x_loc.shape
    E, K = spec.num_experts, spec.top_k
    E_loc = E // mesh.axis_size(EP_AXIS)
    xs = x_loc.reshape(B_loc * S, D)
    x_all = col.all_gather(xs, mesh, EP_AXIS)  # [T_all, D]
    T_all = x_all.shape[0]
    logits = x_all.float() @ router
    cap = expert_capacity(T_all, E, K, spec.capacity_factor)
    g, counts = gating(logits, K, cap)
    # only the assignments to this rank's experts; the rest -> the trash row
    lo = mesh.axis_index(EP_AXIS) * E_loc
    mine = (g.expert_idx >= lo) & (g.expert_idx < lo + E_loc)
    g_local = g._replace(expert_idx=torch.where(mine, g.expert_idx - lo, 0),
                         keep=g.keep & mine,
                         combine_w=torch.where(mine, g.combine_w, 0.0))
    buf = dispatch_dense(x_all, g_local, cap, E_loc)  # [E_loc, cap, D]
    out = _experts(spec, mesh, buf, wi, wg, wo, counts[lo:lo + E_loc].contiguous())
    y_partial = combine_dense(out, g_local, cap, E_loc)  # [T_all, D]: this rank's experts
    # the experts' contributions summed over the EP shards, each its rows
    y = col.psum_scatter(y_partial, mesh, EP_AXIS)
    # the same on every EP shard (from the gathered tokens); the pmean gives
    # the replicated value its transpose
    aux = col.pmean(load_balance_loss(g.probs, g.expert_idx, E), mesh, _batch_axes(mesh))
    return y.reshape(B_loc, S, D), aux


def ep_layout(spec: FFNSpec, mesh: EpMesh,
              rules: Optional[dict] = None) -> Tuple[Tuple[str, ...], bool, int, int]:
    """(expert axes, two-hop exchange, E_loc, F_loc) of ``spec`` on
    ``mesh`` under ``rules`` (the ambient ones by default), as JAX's
    ``moe_layer_ep`` lays out its in_specs; raises where the mesh does not
    divide E or F."""
    sizes = mesh.sizes()
    if EP_AXIS not in sizes:
        raise ValueError(f"moe_impl='ep' needs a {EP_AXIS!r} axis in the mesh {mesh.axis_names}")
    placed = expert_axes(mesh, rules if rules is not None else get_rules(), spec.num_experts)
    hier = placed is not None and "pod" in placed
    axes = ("pod", EP_AXIS) if hier else (EP_AXIS,)
    ep = mesh.axes_size(axes)
    tp = sizes.get(TP_AXIS, 1)
    if spec.num_experts % ep or spec.d_ff % tp:
        raise ValueError(f"moe_impl='ep' on mesh {dict(sizes)}: {spec.num_experts} experts over "
                         f"{axes} ({ep}) and d_ff {spec.d_ff} over {TP_AXIS!r} ({tp}) must divide")
    return axes, hier, spec.num_experts // ep, spec.d_ff // tp


def local_experts(params: dict, spec: FFNSpec, mesh: EpMesh, rules: Optional[dict] = None) -> tuple:
    """This rank's (wi, wg, wo), placed (``shard_params(mode="train")``) or
    cut here from full leaves (``wg`` is ``wi`` where the experts have
    none)."""
    axes, _, E_loc, F_loc = ep_layout(spec, mesh, rules)
    lo = ep_rank(mesh, axes) * E_loc
    f0 = mesh.axis_index(TP_AXIS) * F_loc if TP_AXIS in mesh.axis_names else 0
    out = []
    for k, fdim in (("wi", 2), ("wg", 2), ("wo", 1)):
        w = params.get(k, params["wi"] if k == "wg" else None)
        if w.shape[0] == spec.num_experts:
            w = w[lo:lo + E_loc]
        if w.shape[fdim] == spec.d_ff and F_loc != spec.d_ff:
            w = w.narrow(fdim, f0, F_loc)
        if w.shape[0] != E_loc or w.shape[fdim] != F_loc:
            raise ValueError(f"moe_impl='ep': {k} is {tuple(w.shape)}, expected {E_loc} experts "
                             f"of d_ff {F_loc} on this rank (or all {spec.num_experts} of "
                             f"{spec.d_ff})")
        out.append(w)
    return tuple(out)


def moe_layer_ep(cfg: ModelConfig, spec: FFNSpec, params: dict,
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B_loc, S, D], aux) of the rank's rows ``x`` [B_loc, S, D] under
    the ambient mesh; aux is the global batch's, the same on every rank."""
    mesh = get_mesh()
    if mesh is None:
        raise ValueError("moe_impl='ep' under expert parallelism needs an ambient mesh "
                         "(parallel.sharding.use_mesh)")
    _, hier, _, _ = ep_layout(spec, mesh)
    wi, wg, wo = local_experts(params, spec, mesh)
    t_loc = x.shape[0] * x.shape[1]
    if t_loc * spec.top_k <= spec.num_experts:
        if hier:
            raise ValueError("the all-gather schedule (t_loc * K <= E) gathers over 'data' only; "
                             "under ep_pod the experts are spread over ('pod', 'data') "
                             "(JAX's moe_layer_ep has no such case either)")
        return _moe_body_allgather(spec, mesh, x, params["router"], wi, wg, wo)
    return _moe_body(spec, mesh, hier, x, params["router"], wi, wg, wo)
