"""RG-LRU recurrent block (RecurrentGemma / Griffin, ``repro/models/rglru.py``)
[arXiv:2402.19427].

The linear recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) with
input-dependent gates.  Prefill and training scan the sequence in parallel
(``lru_scan``: log-step doubling of (a, b) pairs, about ceil(log2 L) rounds
of a few element-wise launches, where JAX runs ``lax.associative_scan``);
decode is one step.  No TPU kernel computes any of it.  Caches (``state``
f32 [B, W], ``conv`` the conv prefix, ``pos``) are written in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LRUSpec, ModelConfig
from repro_torch.models.modules import dense_init
from repro_torch.models.ssm import RESUME_MODES, _causal_conv, _normal
from repro_torch.quant.qarrays import materialize

C_EXP = 8.0  # Griffin's fixed exponent scale

# leaves kept in f32 whatever the parameter type (the JAX package's own)
F32_LEAVES = ("Lambda",)


def init_lru(gen, cfg: ModelConfig, spec: LRUSpec, dtype, device, *, lead=()) -> dict:
    d, w, h = cfg.d_model, spec.lru_width, spec.num_heads
    bw = w // h
    lead = tuple(lead)
    return {
        "in_x": dense_init(gen, d, w, dtype, device, lead=lead),
        "in_gate": dense_init(gen, d, w, dtype, device, lead=lead),
        "conv_w": _normal(gen, lead + (spec.conv_dim, w), 0.1, dtype, device),
        # block-diagonal gates [H, bw, bw]
        "w_input_gate": _normal(gen, lead + (h, bw, bw), 1.0 / math.sqrt(bw), dtype, device),
        "b_input_gate": torch.zeros(lead + (h, bw), dtype=dtype, device=device),
        "w_forget_gate": _normal(gen, lead + (h, bw, bw), 1.0 / math.sqrt(bw), dtype, device),
        "b_forget_gate": torch.zeros(lead + (h, bw), dtype=dtype, device=device),
        # a = sigmoid(Lambda) in (0, 1), initialised near 0.9 - 0.999
        "Lambda": torch.linspace(2.2, 6.9, w).to(device).expand(lead + (w,)).contiguous(),
        "out_proj": dense_init(gen, w, d, dtype, device, lead=lead),
    }


def init_lru_cache(batch: int, spec: LRUSpec, dtype, device, *, lead=()) -> dict:
    lead = tuple(lead)
    return {
        "state": torch.zeros(lead + (batch, spec.lru_width), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, spec.conv_dim - 1, spec.lru_width), dtype=dtype,
                            device=device),
        "pos": torch.zeros(lead + (batch, 1), dtype=torch.int32, device=device),
    }


def _gates(params, x: torch.Tensor, h: int):
    """(a, b) [B, S, W] f32 of the recurrence h_t = a_t h_{t-1} + b_t."""
    B, S, W = x.shape
    bw = W // h
    xh = x.reshape(B, S, h, bw)

    def block_diag(w, b):  # [B, S, H, bw] @ [H, bw, bw] + b
        return torch.einsum("bshi,hij->bshj", xh, materialize(w)) + b

    i_t = torch.sigmoid(block_diag(params["w_input_gate"], params["b_input_gate"]))
    r_t = torch.sigmoid(block_diag(params["w_forget_gate"], params["b_forget_gate"]))
    i_t = i_t.reshape(B, S, W).float()
    r_t = r_t.reshape(B, S, W).float()
    lam = params["Lambda"]
    sp = torch.logaddexp(lam, torch.zeros((), dtype=lam.dtype, device=lam.device))  # softplus
    log_a = -C_EXP * r_t * sp  # log a_t <= 0
    a = torch.exp(log_a)
    multiplier = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, multiplier * i_t * x.float()


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 ([B, L, W]), by log-step doubling
    of the pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2):
    round d combines each step with the one d before it, so ceil(log2 L)
    rounds of a few launches each, whatever L is."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    L = a.shape[1]
    d = 1
    while d < L:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < L:  # the last round needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def lru_layer(
    cfg: ModelConfig,
    spec: LRUSpec,
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (y, cache), the cache updated in place.  Decode and chunked
    prefill resume from the cache's state and conv prefix; in a batched
    chunk (positions [B, S], -1 at padding) the padding steps are inert
    (a = 1, b = 0), so the last step holds each row's state at its last
    valid token."""
    B, S, _ = x.shape
    gate = F.gelu(x @ materialize(params["in_gate"]), approximate="tanh")  # jax.nn.gelu's default
    xb = x @ materialize(params["in_x"])
    resume = cache is not None and (mode.startswith("decode") or mode in RESUME_MODES)
    batched = mode == "prefill_chunk_batched" and positions is not None
    valid = positions >= 0 if batched else None
    valid_len = valid.sum(dim=1) if batched else None
    prefix = cache["conv"] if resume else None
    xb, new_prefix = _causal_conv(xb, materialize(params["conv_w"]), prefix, valid_len)

    a, b = _gates(params, xb, spec.num_heads)  # [B, S, W] f32 each
    if batched:
        a = torch.where(valid[..., None], a, 1.0)
        b = torch.where(valid[..., None], b, 0.0)
    if mode.startswith("decode") and S == 1:
        final = a[:, 0] * cache["state"] + b[:, 0]
        hs = final[:, None]
    else:
        hs = lru_scan(a, b, cache["state"] if resume else None)
        final = hs[:, -1]
    y = (hs.to(x.dtype) * gate) @ materialize(params["out_proj"])

    if cache is not None:
        cache["state"].copy_(final)
        cache["conv"].copy_(new_prefix)
        cache["pos"].add_(S)
    return y, cache
