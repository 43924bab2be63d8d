"""Primitive modules of the port (``repro/models/modules.py``): RMSNorm, the
(Swi)GLU MLP, rotary embeddings, softcap and the initialisers.  Parameters are
plain dicts of tensors; functions take them explicitly, as the JAX package's
``apply`` functions do, and keep its casts."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant.qarrays import materialize

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# Rows of a fan-in init drawn in f32 at a time, so a large leaf (one MoE
# layer's experts are 16 G values at full width) never needs a full-size f32
# copy on the device.
_INIT_CHUNK = 1 << 26


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX package; the draws differ)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype, device, *, lead=()) -> torch.Tensor:
    """Truncated-normal (±3σ) fan-in init of shape ``lead + (in_dim,) + out``,
    std ``1/sqrt(in_dim)``, drawn in f32 and cast to ``dtype``.  ``lead``
    stacks independent draws (experts, repeats) on leading axes."""
    out_shape = tuple(out_shape) if isinstance(out_shape, (tuple, list)) else (out_shape,)
    shape = tuple(lead) + (in_dim,) + out_shape
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    std = 1.0 / math.sqrt(in_dim)
    flat = out.view(-1, in_dim * math.prod(out_shape))
    step = max(1, _INIT_CHUNK // flat.shape[1])
    for i in range(0, flat.shape[0], step):
        rows = flat[i : i + step]
        tmp = torch.empty(rows.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0, generator=gen)
        rows.copy_(tmp * std)
    return out


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device) -> torch.Tensor:
    out = torch.empty((vocab, dim), dtype=torch.float32, device=device)
    if out.is_meta:
        return out.to(dtype)
    return torch.nn.init.normal_(out, 0.0, 0.02, generator=gen).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype, device, *, lead=()) -> dict:
    return {"scale": torch.zeros(tuple(lead) + (dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics; the scale is applied as ``1 + scale``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations and the dense MLP
# ---------------------------------------------------------------------------


def act_fn(name: str):
    return {
        "gelu": lambda h: F.gelu(h, approximate="tanh"),  # jax.nn.gelu's default
        "relu": F.relu,
        "silu": F.silu,
        "swiglu": F.silu,
    }[name]


def init_mlp(gen, d_model: int, d_ff: int, act: str, dtype, device, *, lead=()) -> dict:
    p = {
        "wi": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
        "wo": dense_init(gen, d_ff, d_model, dtype, device, lead=lead),
    }
    if act == "swiglu":
        p["wg"] = dense_init(gen, d_model, d_ff, dtype, device, lead=lead)
    return p


def mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    # materialize: dequantizes MoQ-quantized weights, passes fp ones through
    h = x @ materialize(params["wi"])
    if act == "swiglu":
        h = F.silu(x @ materialize(params["wg"])) * h
    else:
        h = act_fn(act)(h)
    return h @ materialize(params["wo"])


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half, f32 angles)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)  # [dh/2]
    angles = positions[..., None].float() * freqs  # [..., S, dh/2]
    sin = torch.sin(angles)[..., None, :]  # [..., S, 1, dh/2]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# bf16 backward (``repro/models/modules.py:121-138``): an identity whose
# backward casts the gradient to the primal's type.  JAX's VJP promotes
# cotangents to f32 once an f32 loss head is involved; the JAX model casts
# the residual stream's cotangent back at every layer boundary under
# ``BF16_BWD`` (``models/transformer.py``), and so does the port.
# ---------------------------------------------------------------------------


class GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    return GradCast.apply(x)
