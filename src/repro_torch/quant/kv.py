"""``QuantizedKV``: an int8 KV cache with per-(timestep, head) f32 scales
(``repro/quant/kv.py``; DeepSpeed-MoE §5, decode is memory-bound).

One cache tensor (K or V) is two tensors:

  * ``q``      int8 ``[..., T, H_kv, dh]``, symmetric values;
  * ``scale``  f32  ``[..., T, H_kv, 1]``, amax / 127 per (timestep, head).

Each written token is scaled on its own, so a write never touches earlier
entries: the contiguous caches ``[B, T, ...]``, the sliding-window rings
``[B, window, ...]`` (a token overwrites the slot ``pos % window``, scale
and all) and the page pools ``[n_pages + 1, page_size, ...]`` are written
in place, a (q, scale) pair at a time (``models/attention.py``).  At head_dim 128 a token and head
take 132 bytes instead of 256 in bf16.

An all-zero slot quantizes to (q = 0, scale = 1e-8 / 127) and dequantizes to
exact zeros; a fresh cache holds q = 0, scale = 0.
"""
from __future__ import annotations

from typing import Tuple

import torch

_KV_QMAX = 127.0


def kv_quantize_values(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., T, H, dh] -> (q int8 [..., T, H, dh], scale f32 [..., T, H, 1]),
    byte-exact with the JAX function."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / _KV_QMAX
    q = torch.clamp(torch.round(x32 / scale), -_KV_QMAX, _KV_QMAX).to(torch.int8)
    return q, scale


class QuantizedKV:
    """int8 values + f32 per-(timestep, head) scales of one cache tensor; a
    plain holder whose tensors are written in place."""

    __slots__ = ("q", "scale", "orig_dtype")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, orig_dtype: torch.dtype):
        self.q = q
        self.scale = scale
        self.orig_dtype = orig_dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * self.scale.element_size()

    def __repr__(self) -> str:
        return f"QuantizedKV(int8, shape={self.shape}, orig={self.orig_dtype})"

    def __getitem__(self, i) -> "QuantizedKV":
        """Views of both tensors at leading index ``i`` (one repeat of a
        stacked cache)."""
        return QuantizedKV(self.q[i], self.scale[i], self.orig_dtype)

    @classmethod
    def zeros(cls, shape, dtype: torch.dtype, device) -> "QuantizedKV":
        """Empty cache tensor: q = 0, scale = 0 dequantizes to exact zeros."""
        shape = tuple(shape)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device), dtype)

    @classmethod
    def quantize(cls, x: torch.Tensor) -> "QuantizedKV":
        q, scale = kv_quantize_values(x)
        return cls(q, scale, x.dtype)

    def dequantize(self) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(self.orig_dtype)


def materialize_kv(x):
    """Dequantize if quantized, pass through otherwise."""
    if isinstance(x, QuantizedKV):
        return x.dequantize()
    return x


def kv_cache_bytes(caches) -> int:
    """Total bytes of a cache tree (nested dicts of tensors and
    ``QuantizedKV``): packed ints plus scales for the quantized leaves."""
    if isinstance(caches, QuantizedKV):
        return caches.nbytes
    if torch.is_tensor(caches):
        return caches.numel() * caches.element_size()
    return sum(kv_cache_bytes(v) for v in caches.values())
