"""GQA self-attention with contiguous KV caches (``repro/models/attention.py``,
global kind).

Modes ``train`` / ``prefill`` / ``decode`` (uniform batch index) are ported.
The caches are updated in place: the stacked ``[repeats, B, cap, ...]``
tensors the engine allocates are written through per-layer views, so a
decode step never copies a cache.  Softmax runs in f32 exactly as the JAX
``_sdpa`` does (f32 logits, probabilities cast to ``v``'s type); no fused
attention operator is called.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttnSpec, ModelConfig
from repro_torch.models.modules import apply_rope, dense_init, init_rmsnorm, rmsnorm, softcap

NEG_INF = -1e30

# The JAX package chunks queries past Q_CHUNK = 1024 tokens; for global
# attention the chunked result equals ``attend_full`` row for row, so the port
# always attends in full.


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue 1: {item})")


def check_spec(spec: AttnSpec) -> None:
    """Raise for the attention kinds this slice does not port."""
    if spec.kind == "local" and spec.window > 0:
        _unported("local (sliding-window) attention", "item 5, the other mixers")
    if spec.kind == "cross":
        _unported("cross attention", "item 5, the other mixers")
    if spec.kind != "global":
        raise ValueError(f"unknown attention kind {spec.kind!r}")


# ---------------------------------------------------------------------------
# Params and caches
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, spec: AttnSpec, dtype, device, *, lead=()) -> dict:
    H, Hkv, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, d, (H, dh), dtype, device, lead=lead),
        "wk": dense_init(gen, d, (Hkv, dh), dtype, device, lead=lead),
        "wv": dense_init(gen, d, (Hkv, dh), dtype, device, lead=lead),
        "wo": dense_init(gen, H * dh, d, dtype, device, lead=lead).view(lead + (H, dh, d)),
    }
    if spec.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dtype, device, lead=lead)
        p["k_norm"] = init_rmsnorm(dh, dtype, device, lead=lead)
    return p


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int, dtype, device,
                  *, lead=()) -> dict:
    """Contiguous KV cache; ``pos`` holds the absolute position stored in each
    slot (-1 = empty), which is also the validity mask's source."""
    shape = tuple(lead) + (batch, capacity, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(tuple(lead) + (batch, capacity), -1, dtype=torch.int32, device=device),
    }


def _cache_write_prefill(cache: dict, k, v, positions) -> dict:
    """Write a prefill of S tokens into slots ``[0, S)`` (in place)."""
    cap = cache["k"].shape[1]
    S = k.shape[1]
    if S > cap:
        raise ValueError(f"prefill of {S} tokens exceeds the cache capacity {cap}")
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    cache["pos"][:, :S] = positions.to(torch.int32)
    return cache


def _cache_write_decode(cache: dict, k_new, v_new, index: int) -> dict:
    """Write one token per row at slot ``index % capacity`` (uniform index,
    in place)."""
    cap = cache["k"].shape[1]
    slot = index % cap
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][:, slot] = index
    return cache


# ---------------------------------------------------------------------------
# Core scaled-dot-product with GQA + masking
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask, scale: float, cap: float):
    """q: [B,S,H,dh], k/v: [B,T,Hkv,dh], mask: [B,1,1,S,T] or broadcastable.
    Returns [B,S,H,dh].  Logits and softmax in f32."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    logits = logits * scale
    logits = softcap(logits, cap)
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, dh)


def _window_causal_mask(q_pos, k_pos, window: int, causal: bool):
    """q_pos: [B,S] or [S]; k_pos: [B,T] or [T] -> bool [B,1,1,S,T]."""
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    if k_pos.ndim == 1:
        k_pos = k_pos[None]
    q = q_pos[:, :, None]
    k = k_pos[:, None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window > 0:
        m = m & (q - k < window)
    return m[:, None, None]


def attend_full(q, k, v, q_pos, k_pos, spec: AttnSpec, scale: float):
    mask = _window_causal_mask(q_pos, k_pos, spec.window if spec.kind == "local" else 0, spec.causal)
    return _sdpa(q, k, v, mask, scale, spec.logit_softcap)


# ---------------------------------------------------------------------------
# Layer-level apply
# ---------------------------------------------------------------------------


def _proj(x, w):
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d = w.shape[0]
    return (x @ w.reshape(d, -1)).view(*x.shape[:-1], *w.shape[1:])


def attention(
    cfg: ModelConfig,
    spec: AttnSpec,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    index: Optional[int] = None,
):
    """Returns (y, cache).  mode: train | prefill | decode.

    - train:   causal self-attention over x, no cache IO.
    - prefill: the same, and writes the cache (in place).
    - decode:  x is [B, 1, d]; writes the token at slot ``index`` (the
               uniform batch position), then attends over the cache.
    """
    check_spec(spec)
    if mode not in ("train", "prefill", "decode"):
        _unported(f"attention mode {mode!r}", "item 3, the paged ContinuousEngine")
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)

    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rms_eps)
        k = rmsnorm(params["k_norm"], k, cfg.rms_eps)
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)

    if mode == "decode":
        assert cache is not None and S == 1 and index is not None
        cache = _cache_write_decode(cache, k, v, index)
        q_pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
        mask = _window_causal_mask(q_pos, cache["pos"], 0, spec.causal)
        y = _sdpa(q, cache["k"], cache["v"], mask, scale, spec.logit_softcap)
    else:
        pos2d = positions if positions.ndim == 2 else positions[None]
        pos2d = pos2d.expand(B, S)
        y = attend_full(q, k, v, pos2d, pos2d, spec, scale)
        if mode == "prefill" and cache is not None:
            cache = _cache_write_prefill(cache, k, v, pos2d)

    H, dh, d = params["wo"].shape
    out = (y.reshape(B, S, H * dh) @ params["wo"].reshape(H * dh, d))
    return out, cache
