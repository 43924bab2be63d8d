"""The MoE FFN layer (``repro/core/moe.py``; DeepSpeed-MoE §3, §4.1.1, §5).

Dispatch implementations (``cfg.moe_impl``):

  * ``dense``   — the capacity dispatch through the dense token -> (expert,
                  slot) mapping table (core/dispatch.py; the paper's §5.4
                  optimization): gating by the fused gating kernel (kernel 1)
                  with ``expert_capacity`` slots per expert (drops past it),
                  expert MLPs over the ``[E, C, D]`` buffer;
  * ``einsum``  — the same gating and experts, routed by one-hot einsums
                  (core/dispatch_einsum.py; the paper's baseline);
  * ``grouped`` — the dropless expert-sorted dispatch (core/dispatch_grouped.py),
                  whose expert MLP is the grouped kernel (kernel 4, kernel 5
                  for MoQ int8 / int4 experts) for SwiGLU experts, and for
                  GELU / ReLU experts plain batched products over each
                  tile's gathered weights (``grouped_act_ffn``);
  * ``ep_serve``, ``ep_grouped`` — expert-parallel serving
                  (core/moe_serve.py) under an ambient mesh whose
                  ``expert`` axes divide E: the capacity schedules (kernels
                  1 and 2 on each rank's experts) and the grouped one
                  (kernel 4); the serving engines rewrite every capacity
                  impl to ``ep_serve`` and ``grouped`` to ``ep_grouped``
                  under ``cfg.ep_mesh`` (serving/ep.py).  Without a usable
                  mesh they resolve as the JAX package resolves them:
                  ``ep_grouped`` to ``grouped``, ``ep_serve`` to ``dense``
                  (to ``einsum`` under a mesh that cannot shard E);
  * ``ep``      — expert-parallel training's layer (core/moe_parallel.py)
                  under an ambient mesh: each rank's rows gated at the
                  shard's capacity, exchanged over ``data`` (two hops
                  under ``ep_pod``), its experts (d_ff sliced over
                  ``model``), exchanged back and combined, or the
                  all-gather schedule for few tokens; without a mesh it
                  is ``dense``.

Expert MLPs over the capacity buffer (``experts_ffn``): fp SwiGLU through
kernel 2 (under grad with its backward 2b; the grouped dispatch's kernel 4
with 4b), int8 per-channel SwiGLU through kernel 3, other quantized layouts
(int4, group-wise scales) through the plain dequantize path, and GELU / ReLU
experts as plain products in the input type, as the JAX package computes
them outside any Pallas kernel.  ``residual=True`` adds the Residual-MoE
branch (a fixed dense MLP beside the routed experts; llama4's and kimi-k2's
shared expert).

In a serving step sharded by rows (``parallel/sharding.py::use_rows``) x
holds the rank's rows and so does y: the EP serving layer gathers what its
schedule needs (core/moe_serve.py), a one-device dispatch runs over every
row gathered (its capacity is the whole step's, as under JAX's hints), the
residual branch runs on the rank's rows, and routing statistics are taken
over every row.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import FFNSpec, ModelConfig
from repro_torch.core import dispatch, dispatch_einsum, dispatch_grouped
from repro_torch.core.gating import expert_capacity, load_balance_loss, routing_stats, top_k_gating
from repro_torch.core.moe_parallel import moe_layer_ep
from repro_torch.core.moe_serve import moe_layer_ep_serve, serve_ep_axes
from repro_torch.kernels.expert_mlp import expert_mlp
from repro_torch.kernels.expert_mlp_grouped import (
    check_grouped_quant_compat,
    grouped_mlp,
    grouped_mlp_quant,
    grouped_mlp_quant_plain,
)
from repro_torch.kernels.expert_mlp_quant import (
    check_kernel_compat,
    expert_mlp_quant,
    expert_mlp_quant_plain,
)
from repro_torch.kernels.moe_gating import gating
from repro_torch.models.modules import act_fn, dense_init, init_mlp, mlp
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import get_mesh, get_rows, use_rows
from repro_torch.quant.qarrays import QuantizedArray, dequantize_values, materialize

# the most bytes of per-tile expert weights (gathered, and their f32 copies)
# that one block of ``grouped_act_ffn`` holds at a time
GATHER_BYTES = 1 << 30

# the expert-parallel names without a mesh (``repro/core/moe.py``: "ep" and
# "ep_serve" take the dense mapping table, "ep_grouped" the grouped kernel)
EP_SERVE_IMPLS = ("ep_serve", "ep_grouped")
NO_MESH_IMPL = {"ep": "dense", "ep_serve": "dense", "ep_grouped": "grouped"}
IMPLS = ("dense", "einsum", "grouped", *NO_MESH_IMPL)


def init_moe(gen, cfg: ModelConfig, spec: FFNSpec, dtype, device, *, lead=()) -> dict:
    d, f, e = cfg.d_model, spec.d_ff, spec.num_experts
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, d, e, torch.float32, device, lead=lead),  # router in f32
        "wi": dense_init(gen, d, f, dtype, device, lead=lead + (e,)),  # [E, D, F]
        "wo": dense_init(gen, f, d, dtype, device, lead=lead + (e,)),  # [E, F, D]
    }
    if spec.act == "swiglu":
        p["wg"] = dense_init(gen, d, f, dtype, device, lead=lead + (e,))
    if spec.residual:
        p["residual"] = init_mlp(gen, d, spec.residual_d_ff or spec.d_ff, spec.act, dtype, device, lead=lead)
    return p


def experts_ffn(params: dict, xe: torch.Tensor, act: str, fill=None, n_assign=None) -> torch.Tensor:
    """xe [E, C, D] -> [E, C, D]: each expert's MLP over its capacity buffer.
    ``fill`` ([E] int32, the gating kernel's counts): rows at or past it are
    zero, which lets the SwiGLU kernels skip them.  ``n_assign``: the
    assignments the buffer can hold at most (T*K, static), which bounds the
    int8 tensor-core kernel's grid."""
    wi, wo = params["wi"], params["wo"]
    if isinstance(wi, QuantizedArray):
        return _experts_ffn_quant(params, xe, act, fill, n_assign)
    if act == "swiglu":
        return expert_mlp(xe, wi, params["wg"], wo, fill)
    # GELU / ReLU experts: plain batched products in the input type, as the
    # JAX package's einsums (no Pallas kernel computes them there either)
    return torch.bmm(act_fn(act)(torch.bmm(xe, wi)), wo)


def _experts_ffn_quant(params: dict, xe: torch.Tensor, act: str, fill, n_assign) -> torch.Tensor:
    """Quantized experts: kernel 3 where ``check_kernel_compat`` takes the
    layout (int8 per output column), else the plain dequantize path, as the
    JAX package's ``_experts_ffn_quant`` does on the TPU.  The choice reads
    the weights' layout and the shapes only."""
    wi, wo = params["wi"], params["wo"]
    wg = params.get("wg")
    if act == "swiglu":
        if check_kernel_compat(xe, wi, wg, wo):
            return expert_mlp_quant(xe, wi, wg, wo, fill, n_assign)
        return expert_mlp_quant_plain(xe, wi, wg, wo, fill)
    return torch.bmm(act_fn(act)(torch.bmm(xe, materialize(wi))), materialize(wo))


def _gathered(w, idx: torch.Tensor) -> torch.Tensor:
    """Experts ``idx`` of a [E, Din, Dout] leaf, [n, Din, Dout] in f32: a
    quantized leaf dequantized to its original type first, as
    ``QuantizedArray.dequantize`` does in JAX."""
    if isinstance(w, QuantizedArray):
        w = dequantize_values(w.q[idx], w.scale[idx], w.bits, w.group_size, w.axis, w.orig_dtype)
    else:
        w = w[idx]
    return w.float()


def grouped_act_ffn(params: dict, xg: torch.Tensor, te: torch.Tensor, act: str,
                    n_assign: Optional[int] = None) -> torch.Tensor:
    """GELU / ReLU experts over the grouped layout (xg [Ct, D], te [Ct /
    tile]) -> [Ct, D]: what the JAX package's ``grouped_mlp_ref`` /
    ``grouped_mlp_quant_ref`` compute outside any Pallas kernel, each tile's
    expert weights gathered, f32 products, the activation rounded to the
    input type.  The live tiles are a prefix of at most ``n_assign`` (T*K:
    each holds an assignment) tiles; only those are computed, and the rest
    are zeros, as every activation maps their zero rows to.  They go in
    blocks whose gathered weights stay under ``GATHER_BYTES``.  The tile
    and block counts follow from the shapes, so no step reads a device
    value."""
    wi, wo = params["wi"], params["wo"]
    Ct, D = xg.shape
    nt = te.shape[0]
    live = nt if n_assign is None else min(nt, n_assign)
    F = wi.shape[-1]
    step = max(1, GATHER_BYTES // (2 * D * F * (wi.dtype.itemsize + 4)))
    fn = act_fn(act)
    xt = xg.view(nt, Ct // nt, D)
    out = torch.zeros_like(xt)
    for t0 in range(0, live, step):
        t1 = min(live, t0 + step)
        idx = te[t0:t1].long()
        h = fn(torch.bmm(xt[t0:t1].float(), _gathered(wi, idx))).to(xg.dtype)
        out[t0:t1] = torch.bmm(h.float(), _gathered(wo, idx)).to(xg.dtype)
    return out.view(Ct, D)


def grouped_experts_ffn(params: dict, xg, te, rows_used, act: str,
                        n_assign: Optional[int] = None):
    """xg: [Ct, D] expert-sorted tile-padded tokens; te: [Ct/tile] tile ->
    expert map -> [Ct, D], through the grouped kernel (SwiGLU experts).

    Quantized experts take kernel 5 when their layout suits it
    (``check_grouped_quant_compat``: per-output-column scales); others
    (group-wise scales) take the plain dequantize path, as the JAX package
    does on the TPU.  The choice reads the weights' layout only.  GELU /
    ReLU experts take ``grouped_act_ffn``, fp and quantized, over at most
    ``n_assign`` (T*K) live tiles."""
    if act != "swiglu":
        return grouped_act_ffn(params, xg, te, act, n_assign)
    wi, wg, wo = params["wi"], params["wg"], params["wo"]
    if isinstance(wi, QuantizedArray):
        if check_grouped_quant_compat(wi, wg, wo):
            return grouped_mlp_quant(xg, te, wi, wg, wo, rows_used)
        return grouped_mlp_quant_plain(xg, te, wi, wg, wo, rows_used)
    return grouped_mlp(xg, te, wi, wg, wo, rows_used)


def moe_layer(
    cfg: ModelConfig,
    spec: FFNSpec,
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    *,
    impl: str | None = None,
    with_stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Returns (y [B, S, D], aux_loss); with ``with_stats=True`` a third
    element, the layer's ``RoutingStats`` (no gradient)."""
    impl = impl or cfg.moe_impl
    if impl not in IMPLS:
        raise ValueError(f"moe_impl={impl!r}: expected one of {IMPLS}")
    if impl in EP_SERVE_IMPLS:
        if serve_ep_axes(spec.num_experts) is not None:
            return _moe_layer_ep_serve(cfg, spec, params, x, impl, with_stats)
        # no mesh that shards E: the equivalent one-device dispatch; under a
        # multi-rank mesh the mapping table refuses, so the capacity
        # fallback there is the einsum dispatch, as in the JAX package
        impl = "grouped" if impl == "ep_grouped" else (
            "einsum" if get_mesh() is not None else "dense")
    elif impl == "ep" and get_mesh() is not None:
        return _moe_layer_ep(cfg, spec, params, x, with_stats)
    rows = get_rows()
    if rows is not None:
        with use_rows(None):
            out = moe_layer(cfg, spec, params, col.all_gather(x, rows.mesh, rows.axes),
                            impl=impl, with_stats=with_stats)
        return (rows.take(out[0]),) + tuple(out[1:])
    impl = NO_MESH_IMPL.get(impl, impl)
    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    T = B * S
    xs = x.reshape(T, D)
    logits = xs.float() @ params["router"]
    if impl == "grouped":
        # dropless: capacity = T*K, so every assignment keeps its expert
        g = top_k_gating(logits, K, T * K)
        y = dispatch_grouped.moe_grouped(
            xs, g, E, lambda xg, te, rows: grouped_experts_ffn(params, xg, te, rows, spec.act,
                                                               T * K))
    else:
        capacity = expert_capacity(T, E, K, spec.capacity_factor)
        g, counts = gating(logits, K, capacity)
        ef = lambda xe: experts_ffn(params, xe, spec.act, counts, T * K)
        if impl == "einsum":
            y = dispatch_einsum.moe_einsum(xs, g, capacity, ef)
        else:  # dense mapping table
            y = dispatch.moe_dense(xs, g, capacity, E, ef)
    aux = load_balance_loss(g.probs, g.expert_idx, E)
    y = y.reshape(B, S, D)
    if spec.residual:
        y = y + mlp(params["residual"], x, spec.act)
    if with_stats:
        return y, aux, routing_stats(g, E)
    return y, aux


def _moe_layer_ep_serve(cfg: ModelConfig, spec: FFNSpec, params: dict, x: torch.Tensor,
                        impl: str, with_stats: bool) -> Tuple[torch.Tensor, ...]:
    """The serving EP layer (core/moe_serve.py) under the ambient mesh.
    Quantized expert leaves are dequantized here (the engines do it once at
    load time: ``quant.ptq.prepare_params_for_serving``).  ``with_stats``
    re-runs the router and the gating on the replicated token set: for the
    replicated-token schedules exactly the gating the dispatch used; for the
    a2a prefill its drop accounting is the global capacity's, not the
    per-shard capacity's (the JAX package's caveat)."""
    if isinstance(params.get("wi"), QuantizedArray):
        params = {**params, **{k: materialize(params[k]) for k in ("wi", "wg", "wo") if k in params}}
    rows = get_rows()
    y, aux = moe_layer_ep_serve(cfg, spec, params, x, rows=rows,
                                kernel="grouped" if impl == "ep_grouped" else "dense")
    if spec.residual:
        y = y + mlp(params["residual"], x, spec.act)
    if not with_stats:
        return y, aux
    if rows is not None:
        x = col.all_gather(x, rows.mesh, rows.axes)
    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    logits = x.reshape(B * S, D).float() @ params["router"]
    if impl == "ep_grouped":
        g = top_k_gating(logits, K, B * S * K)
    else:
        g, _ = gating(logits, K, expert_capacity(B * S, E, K, spec.capacity_factor))
    return y, aux, routing_stats(g, E)


def _moe_layer_ep(cfg: ModelConfig, spec: FFNSpec, params: dict, x: torch.Tensor,
                  with_stats: bool) -> Tuple[torch.Tensor, ...]:
    """The training EP layer (core/moe_parallel.py) on this rank's rows.
    ``with_stats`` gates the replicated token set (the rows of every batch
    rank, gathered without gradient) at the global capacity: the router's
    probabilities, top-k, f and P are the sharded dispatch's, but its drop
    accounting is the global capacity's, not each shard's (the JAX
    package's caveat)."""
    if isinstance(params.get("wi"), QuantizedArray):
        params = {**params, **{k: materialize(params[k]) for k in ("wi", "wg", "wo") if k in params}}
    y, aux = moe_layer_ep(cfg, spec, params, x)
    if spec.residual:
        y = y + mlp(params["residual"], x, spec.act)
    if not with_stats:
        return y, aux
    from repro_torch.core.moe_parallel import _batch_axes
    from repro_torch.parallel import collectives as col

    mesh = get_mesh()
    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    with torch.no_grad():
        xs = col.all_gather(x.reshape(B * S, D), mesh, _batch_axes(mesh))
        g, _ = gating(xs.float() @ params["router"], K,
                      expert_capacity(xs.shape[0], E, K, spec.capacity_factor))
    return y, aux, routing_stats(g, E)
