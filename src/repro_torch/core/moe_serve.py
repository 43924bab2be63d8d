"""Expert-parallel MoE schedules of the serving engines
(``repro/core/moe_serve.py``; paper §5.2-5.3) on ``torch.distributed``.

Each rank runs the layer on the same replicated input ``x`` with its own
slice of the experts (``parallel/params.py``): ``wi`` / ``wg`` / ``wo`` of
experts ``[r * E_loc, (r + 1) * E_loc)``, r the rank's linear index over the
EP axes.  A full leaf (``E`` experts) is cut to that slice here, so the
layer also takes unplaced parameters.  Three schedules, chosen as JAX
chooses them (``schedule_of``):

  * **replicated-token, capacity** (``replicated_dense``): every rank runs the
    global gating (kernel 1: the same capacity and drops everywhere), keeps
    the assignments to its own experts, runs its expert MLPs over
    ``[E_loc, cap, D]`` (kernel 2 for SwiGLU experts) and all-gathers the
    full ``[E, cap, D]`` output before the replicated combine.  Each output
    row has one owner, so the combine is the one-device combine on the same
    values.
  * **replicated-token, grouped** (``replicated_grouped``): the global
    dropless grouped layout on every rank, tiles of other ranks' experts
    zeroed and their expert ids clamped to 0, the grouped expert MLP
    (kernel 4) over all ``Ct`` rows with this rank's weights, then a sum of
    the f32 ``[Ct, D]`` outputs (one non-zero contributor a row: exact) and
    the one-device combine.
  * **a2a**: tokens zero-padded at the end to a multiple of the EP size and
    sharded over it; gating per shard with per-shard capacity (kernel 1);
    the ``[E, cap, D]`` buffers exchanged by the flat all-to-all, or on a
    two-axis mesh the hierarchical two-hop one (Fig. 8); the expert MLPs
    over ``[E_loc, ep * cap, D]``; the exchange back, the per-shard combine
    and an all-gather of the tokens.  The aux loss is built from the
    pmean'd ``(f, P)``.  Capacity is per shard, so it equals the one-device
    layer only where nothing drops.

In a serving step whose rows are sharded (``rows``, slot-sharded serving:
``parallel/sharding.py``) ``x`` holds the rank's rows of the step.  The
replicated-token schedules gather every row first and keep the rank's rows
of the output (JAX's ``constrain(x, P())`` and the ``batch`` hint after the
layer).  The a2a schedule takes the rank's rows flattened as its token
shard, with no gather, where the rows shard over every EP axis: then the
step's T = B S tokens divide by the EP size (no padding) and the rank's
rows are exactly JAX's shard of them (the paper's dataflow, JAX's
per-shard capacity).  Rows over some of the EP axes are gathered, then
padded and split as above.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import FFNSpec, ModelConfig
from repro_torch.core.dispatch import combine_dense, dispatch_dense
from repro_torch.core.dispatch_grouped import GROUPED_TILE, combine_grouped, scatter_grouped
from repro_torch.core.gating import expert_capacity, load_balance_loss, load_balance_stats, top_k_gating
from repro_torch.kernels.moe_gating import gating
from repro_torch.parallel import collectives as col
from repro_torch.parallel.params import ep_rank, expert_axes
from repro_torch.parallel.sharding import EpMesh, RowShard, get_mesh, get_rules

SCHEDULES = ("replicated_dense", "replicated_grouped", "a2a")


def serve_ep_axes(num_experts: int, mesh: Optional[EpMesh] = None) -> Optional[Tuple[str, ...]]:
    """EP mesh axes for serving, or None where the (ambient) mesh cannot
    shard this expert count: the ``expert`` rule's axes must all be in the
    mesh and their product must be above 1 and divide E, the rule by which
    ``parallel/params.py`` places the weights."""
    return expert_axes(mesh if mesh is not None else get_mesh(), get_rules(), num_experts)


def schedule_of(kernel: str, num_tokens: int, spec: FFNSpec) -> str:
    """JAX's rule: the grouped kernel, or few tokens (``T * K <= E``: decode),
    take the replicated-token schedule; the capacity kernel on more tokens
    (prefill) takes the a2a exchange."""
    if kernel == "grouped":
        return "replicated_grouped"
    if num_tokens * spec.top_k <= spec.num_experts:
        return "replicated_dense"
    return "a2a"


def local_experts(params: dict, spec: FFNSpec, mesh: EpMesh, axes) -> dict:
    """This rank's ``wi`` / ``wg`` / ``wo`` ([E_loc, ...]), cut from full
    leaves where they are not placed yet."""
    E = spec.num_experts
    E_loc = E // mesh.axes_size(axes)
    lo = ep_rank(mesh, axes) * E_loc
    keys = ("wi", "wg", "wo") if spec.act == "swiglu" else ("wi", "wo")
    out = {}
    for k in keys:
        w = params[k]
        if w.shape[0] == E_loc:
            out[k] = w
        elif w.shape[0] == E:
            out[k] = w[lo:lo + E_loc]
        else:
            raise ValueError(f"moe_serve: {k} holds {w.shape[0]} experts, expected {E} or "
                             f"this rank's {E_loc}")
    return out


def _replicated_dense(spec: FFNSpec, mesh: EpMesh, axes, x: torch.Tensor, params: dict):
    from repro_torch.core.moe import experts_ffn

    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    E_loc = E // mesh.axes_size(axes)
    T = B * S
    cap = expert_capacity(T, E, K, spec.capacity_factor)
    xs = x.reshape(T, D)
    logits = xs.float() @ params["router"]
    g, counts = gating(logits, K, cap)  # global gating, the same on every rank
    # this rank's assignments; positions and keep come from the global
    # gating, so the local buffer rows are the one-device buffer's rows
    lo = ep_rank(mesh, axes) * E_loc
    mine = (g.expert_idx >= lo) & (g.expert_idx < lo + E_loc)
    g_loc = g._replace(expert_idx=torch.where(mine, g.expert_idx - lo, 0),
                       keep=g.keep & mine,
                       combine_w=torch.where(mine, g.combine_w, 0.0))
    buf = dispatch_dense(xs, g_loc, cap, E_loc)  # [E_loc, cap, D]
    out_loc = experts_ffn(local_experts(params, spec, mesh, axes), buf, spec.act,
                          counts[lo:lo + E_loc].contiguous(), T * K)
    # the full [E, cap, D] output, rank-major = expert order, then the
    # replicated one-device combine
    out = col.all_gather(out_loc, mesh, axes)
    y = combine_dense(out, g, cap, E).reshape(B, S, D)
    aux = col.pmean(load_balance_loss(g.probs, g.expert_idx, E), mesh, axes)
    return y, aux


def _replicated_grouped(spec: FFNSpec, mesh: EpMesh, axes, x: torch.Tensor, params: dict):
    from repro_torch.core.moe import grouped_experts_ffn

    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    E_loc = E // mesh.axes_size(axes)
    T = B * S
    xs = x.reshape(T, D)
    logits = xs.float() @ params["router"]
    g = top_k_gating(logits, K, T * K)  # dropless global gating
    layout, xg = scatter_grouped(xs, g, E)
    # tiles of other ranks' experts: rows zeroed, expert ids clamped into
    # this rank's [0, E_loc) (the trailing tiles past rows_used hold no row)
    lo = ep_rank(mesh, axes) * E_loc
    te = layout.tile_expert
    tile_mine = (te >= lo) & (te < lo + E_loc)
    te_loc = torch.where(tile_mine, te - lo, 0).to(torch.int32)
    row_mine = tile_mine.repeat_interleave(GROUPED_TILE)[:, None]
    xg_loc = torch.where(row_mine, xg, 0)
    yg_loc = grouped_experts_ffn(local_experts(params, spec, mesh, axes), xg_loc, te_loc,
                                 layout.rows_used, spec.act, T * K)
    yg_loc = torch.where(row_mine, yg_loc.float(), 0.0)
    yg = col.psum(yg_loc, mesh, axes)  # [Ct, D] f32, one contributor a row
    y = combine_grouped(yg, layout, g, xs.dtype).reshape(B, S, D)
    aux = col.pmean(load_balance_loss(g.probs, g.expert_idx, E), mesh, axes)
    return y, aux


def _a2a(spec: FFNSpec, mesh: EpMesh, axes, x_loc: torch.Tensor, params: dict):
    """x_loc [T_loc, D]: this rank's slice of the end-padded tokens."""
    from repro_torch.core.moe import experts_ffn

    T_loc, D = x_loc.shape
    E, K = spec.num_experts, spec.top_k
    cap = expert_capacity(T_loc, E, K, spec.capacity_factor)
    logits = x_loc.float() @ params["router"]
    g, _ = gating(logits, K, cap)
    buf = dispatch_dense(x_loc, g, cap, E)  # [E, cap, D]
    if len(axes) == 2:
        # two hops: the inner axis first; experts are laid out outer-major
        recv = col.hierarchical_all_to_all(buf, mesh, axes[1], axes[0])
    else:
        recv = col.flat_all_to_all(buf, mesh, axes)
    # recv [E_loc, ep * cap, D]: each source's block fills a prefix of its
    # cap rows, so no per-expert fill bounds the rows; every row is computed
    out = experts_ffn(local_experts(params, spec, mesh, axes), recv, spec.act)
    if len(axes) == 2:
        back = col.hierarchical_all_to_all_back(out, mesh, axes[1], axes[0])
    else:
        back = col.flat_all_to_all_back(out, mesh, axes)
    y = combine_dense(back, g, cap, E)  # [T_loc, D]
    # the global batch's aux: pmean the linear per-expert stats, then the product
    f, p = load_balance_stats(g.probs, g.expert_idx, E)
    f = col.pmean(f, mesh, axes)
    p = col.pmean(p, mesh, axes)
    return y, E * torch.sum(f * p)


def ep_schedule(schedule: str, spec: FFNSpec, params: dict, x: torch.Tensor, mesh: EpMesh,
                axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, D], aux) of ``schedule`` on ``mesh`` over ``axes``, which
    may be a one-rank mesh (every collective the identity)."""
    if schedule == "replicated_dense":
        return _replicated_dense(spec, mesh, axes, x, params)
    if schedule == "replicated_grouped":
        return _replicated_grouped(spec, mesh, axes, x, params)
    if schedule != "a2a":
        raise ValueError(f"schedule {schedule!r}: expected one of {SCHEDULES}")
    # zero-pad at the END to a multiple of the EP size (pads come last in
    # token-major order, so they never take a real token's capacity slot)
    # and take this rank's contiguous shard, rank-major as the gather below
    B, S, D = x.shape
    T = B * S
    ep = mesh.axes_size(axes)
    xs = x.reshape(T, D)
    Tp = -(-T // ep) * ep
    if Tp != T:
        xs = torch.cat([xs, xs.new_zeros((Tp - T, D))])
    T_loc = Tp // ep
    r = ep_rank(mesh, axes)
    y_loc, aux = _a2a(spec, mesh, axes, xs[r * T_loc:(r + 1) * T_loc], params)
    y = col.all_gather(y_loc, mesh, axes)
    return y[:T].reshape(B, S, D), aux


def moe_layer_ep_serve(cfg: ModelConfig, spec: FFNSpec, params: dict, x: torch.Tensor, *,
                       kernel: str = "dense",
                       rows: Optional[RowShard] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving EP layer (``kernel`` ``"dense"``, the capacity dispatch, or
    ``"grouped"``).  The caller (``core/moe.py``) guarantees an ambient mesh
    whose ``expert`` rule axes divide ``spec.num_experts``.  ``rows``: x
    holds the rank's rows of a step sharded by rows, and so does the output
    (the module docstring)."""
    mesh = get_mesh()
    axes = serve_ep_axes(spec.num_experts)
    if mesh is None or axes is None:
        raise ValueError("moe_layer_ep_serve needs an ambient mesh that shards "
                         f"{spec.num_experts} experts")
    B, S, D = x.shape
    if rows is None:
        return ep_schedule(schedule_of(kernel, B * S, spec), spec, params, x, mesh, axes)
    schedule = schedule_of(kernel, rows.n * S, spec)
    if schedule == "a2a" and rows.axes == tuple(axes):
        y, aux = _a2a(spec, mesh, axes, x.reshape(B * S, D), params)
        return y.reshape(B, S, D), aux
    y, aux = ep_schedule(schedule, spec, params, col.all_gather(x, mesh, rows.axes), mesh, axes)
    return rows.take(y), aux
