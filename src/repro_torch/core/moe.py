"""The MoE FFN layer (``repro/core/moe.py``; DeepSpeed-MoE §3, §4.1.1, §5).

The port has the grouped (dropless) dispatch, whose expert MLP is the
hand-written grouped kernel (kernel 4 for fp experts, kernel 5 for MoQ int8 /
int4 experts), and the Residual-MoE branch (a fixed dense MLP beside the
routed experts; llama4's and kimi-k2's shared expert).  The other dispatch
implementations raise, naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import FFNSpec, ModelConfig
from repro_torch.core import dispatch_grouped
from repro_torch.core.gating import load_balance_loss, top_k_gating
from repro_torch.kernels.expert_mlp_grouped import (
    check_grouped_quant_compat,
    grouped_mlp,
    grouped_mlp_quant,
    grouped_mlp_quant_plain,
)
from repro_torch.models.modules import dense_init, init_mlp, mlp
from repro_torch.quant.qarrays import QuantizedArray


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


def grouped_experts_ffn(params: dict, xg, te, rows_used, act: str):
    """xg: [Ct, D] expert-sorted tile-padded tokens; te: [Ct/tile] tile ->
    expert map -> [Ct, D], through the grouped kernel (SwiGLU experts).

    Quantized experts take kernel 5 when their layout suits it
    (``check_grouped_quant_compat``: per-output-column scales); others
    (group-wise scales) take the plain dequantize path, as the JAX package
    does on the TPU.  The choice reads the weights' layout only."""
    if act != "swiglu":
        raise NotImplementedError(
            f"grouped experts with act={act!r} are not ported yet: the grouped "
            "kernel is SwiGLU-only (ROADMAP.md, queue 2: nlg GELU experts)")
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, D], aux_loss)."""
    impl = impl or cfg.moe_impl
    if impl != "grouped":
        raise NotImplementedError(
            f"moe_impl={impl!r} is not ported yet; this slice serves moe_impl='grouped' "
            "(ROADMAP.md, queue 1 item 2: dense/einsum dispatch; item 7: expert parallelism)")
    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    T = B * S
    xs = x.reshape(T, D)
    logits = xs.float() @ params["router"]
    # dropless: capacity = T*K, so every assignment keeps its expert
    g = top_k_gating(logits, K, T * K)
    y = dispatch_grouped.moe_grouped(
        xs, g, E, lambda xg, te, rows: grouped_experts_ffn(params, xg, te, rows, spec.act))
    aux = load_balance_loss(g.probs, g.expert_idx, E)
    y = y.reshape(B, S, D)
    if spec.residual:
        y = y + mlp(params["residual"], x, spec.act)
    return y, aux
