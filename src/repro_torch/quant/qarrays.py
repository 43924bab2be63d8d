"""``QuantizedArray``: a weight stored as integer values plus f32 scales
(``repro/quant/qarrays.py``; MoQ, DeepSpeed-MoE §4).

An ``nn.Module`` with two buffers, ``q`` (int8 storage) and ``scale`` (f32),
and plain attributes ``bits``, ``group_size``, ``axis`` (negative) and
``orig_dtype``.  A :class:`~repro_torch.models.model.ParamTree` nests it like
any subtree, so ``.to()`` moves both buffers and the flattened keys are
``.../wi/q`` and ``.../wi/scale``, the JAX checkpoint manifest's.

Quantization is symmetric and byte-exact with the JAX package on the same
input: amax over the contraction axes in f32, ``scale = max(amax, 1e-8) /
qmax``, ``round(w / scale)`` (half to even on both sides), clipped to
``[-qmax, qmax]``.

  * int8: one scale per output column (or per ``group_size`` inputs along
    the first contraction axis).
  * int4: the same with qmax 7, two nibbles packed per int8 byte along the
    first contraction axis: byte ``i`` holds ``(2i) | (2i+1) << 4``.

``axis`` is stored relative to the end of the shape, so a leaf sliced along
its leading stack axes (repeats, experts) keeps valid metadata.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

_QMAX = {8: 127.0, 4: 7.0}


def _norm_neg_axis(axis: int, ndim: int) -> int:
    return axis % ndim - ndim


def _pack_int4(q: torch.Tensor, ax: int) -> torch.Tensor:
    """Pack adjacent int4 pairs along ``ax``: byte i holds (2i | 2i+1 << 4).
    The byte is built in int32 and goes through uint8 before it is
    reinterpreted as int8 (values 128-255 are never cast to int8)."""
    qm = q.movedim(ax, -1).to(torch.int32)
    lo = qm[..., 0::2] & 0xF
    hi = qm[..., 1::2] & 0xF
    packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return packed.movedim(-1, ax).contiguous()


def _unpack_int4(q: torch.Tensor, ax: int) -> torch.Tensor:
    """Inverse of :func:`_pack_int4`: sign-extended int8 nibbles."""
    qm = q.movedim(ax, -1).to(torch.int32) & 0xFF
    lo = qm & 0xF
    hi = (qm >> 4) & 0xF
    lo = lo - 16 * (lo > 7).to(torch.int32)
    hi = hi - 16 * (hi > 7).to(torch.int32)
    inter = torch.stack([lo, hi], dim=-1).reshape(*qm.shape[:-1], qm.shape[-1] * 2)
    return inter.to(torch.int8).movedim(-1, ax)


def dequantize_values(q: torch.Tensor, scale: torch.Tensor, bits: int, group_size: int,
                      axis: int, dtype: torch.dtype) -> torch.Tensor:
    """(q, scale) -> the weight in ``dtype``: widened to f32, times its
    scale, then cast, as ``QuantizedArray.dequantize`` in JAX."""
    if bits == 4:
        q = _unpack_int4(q, axis)
    w = q.to(torch.float32)
    if group_size > 0:
        ax = axis % w.ndim
        shape = w.shape
        w = w.reshape(*shape[:ax], shape[ax] // group_size, group_size, *shape[ax + 1:])
        w = (w * scale.unsqueeze(ax + 1)).reshape(shape)
    else:
        w = w * scale
    return w.to(dtype)


def _quantize_core(w: torch.Tensor, bits: int, group_size: int, axes: Tuple[int, ...]):
    """Quantize one weight (no leading stack axes to slice): (q, scale)."""
    nd = w.ndim
    ax = axes[0] % nd
    qmax = _QMAX[bits]
    w32 = w.to(torch.float32)
    if group_size > 0:
        din = w.shape[ax]
        gshape = (*w.shape[:ax], din // group_size, group_size, *w.shape[ax + 1:])
        wg = w32.reshape(gshape)
        red = (ax + 1,) + tuple((a % nd) + (1 if (a % nd) > ax else 0) for a in axes[1:])
        amax = wg.abs().amax(dim=red, keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) / qmax
        q = torch.clamp(torch.round(wg / scale), -qmax, qmax).to(torch.int8).reshape(w.shape)
        scale = scale.squeeze(ax + 1)
    else:
        amax = w32.abs().amax(dim=tuple(a % nd for a in axes), keepdim=True)
        scale = torch.clamp_min(amax, 1e-8) / qmax
        q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        q = _pack_int4(q, ax)
    return q, scale


class QuantizedArray(nn.Module):
    """values (``q``, int8 storage) + scales (``scale``, f32) + metadata."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int, group_size: int,
                 axis: int, orig_dtype: torch.dtype):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bits = bits  # 8 | 4
        self.group_size = group_size  # 0 = per output channel
        self.axis = axis  # negative: the pack / group (first contraction) axis
        self.orig_dtype = orig_dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self.q.shape)
        if self.bits == 4:
            s[self.axis] *= 2  # two nibbles per stored byte along the pack axis
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.orig_dtype

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * self.scale.element_size()

    def extra_repr(self) -> str:
        return (f"int{self.bits}, shape={self.shape}, group_size={self.group_size}, "
                f"axis={self.axis}, orig={self.orig_dtype}")

    def take(self, i: int) -> "QuantizedArray":
        """Index ``i`` of the leading axis (a repeat of a stacked leaf, or an
        expert), as views of ``q`` and ``scale``."""
        if self.q.ndim - 1 < -self.axis:
            raise ValueError("take would cut into the leaf's contraction axes")
        return QuantizedArray(self.q[i], self.scale[i], self.bits, self.group_size, self.axis,
                              self.orig_dtype)

    @classmethod
    def quantize(cls, w: torch.Tensor, *, bits: int = 8, group_size: int = 0,
                 reduce_axes: Tuple[int, ...] = (-2,)) -> "QuantizedArray":
        """Symmetric quantization of ``w``; ``reduce_axes`` are the contraction
        axes of the product ``w`` feeds (amax runs over them; grouping and
        packing go along ``reduce_axes[0]``).

        Axes before the contraction and output axes (stack axes such as
        ``[R, E]``) are quantized one slice at a time: amax never crosses
        them, so the bytes are those of the whole-tensor computation, and the
        f32 temporary stays the size of one slice."""
        if bits not in _QMAX:
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        nd = w.ndim
        axes = tuple(_norm_neg_axis(a, nd) for a in reduce_axes)
        ax = axes[0] % nd
        if group_size > 0:
            if w.shape[ax] % group_size:
                raise ValueError(f"group_size {group_size} must divide axis dim {w.shape[ax]}")
            if bits == 4 and group_size % 2:
                raise ValueError("int4 group_size must be even (nibble packing)")
        if bits == 4 and w.shape[ax] % 2:
            raise ValueError(f"int4 needs an even dim on axis {ax}, got {w.shape[ax]}")
        core = -min(axes)  # trailing axes that one slice keeps
        if nd > core and math.prod(w.shape[: nd - core]) > 1:
            lead = w.shape[: nd - core]
            flat = w.reshape(-1, *w.shape[nd - core:])
            q0, s0 = _quantize_core(flat[0], bits, group_size, axes)
            q = torch.empty((flat.shape[0], *q0.shape), dtype=q0.dtype, device=w.device)
            scale = torch.empty((flat.shape[0], *s0.shape), dtype=s0.dtype, device=w.device)
            q[0], scale[0] = q0, s0
            for i in range(1, flat.shape[0]):
                q[i], scale[i] = _quantize_core(flat[i], bits, group_size, axes)
            q = q.reshape(*lead, *q0.shape)
            scale = scale.reshape(*lead, *s0.shape)
        else:
            q, scale = _quantize_core(w, bits, group_size, axes)
        return cls(q, scale, bits, group_size, _norm_neg_axis(ax, nd), w.dtype)

    def dequantize(self) -> torch.Tensor:
        return dequantize_values(self.q, self.scale, self.bits, self.group_size, self.axis,
                                 self.orig_dtype)


def materialize(w):
    """Dequantize if quantized, else pass through: the hook that lets every
    product site take fp or quantized weights."""
    if isinstance(w, QuantizedArray):
        return w.dequantize()
    return w
