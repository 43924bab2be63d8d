"""Grouped (dropless) expert SwiGLU MLP: the wrappers of the hand-written
Hopper kernel ``csrc/grouped_mlp.cu`` and their plain PyTorch versions.

``grouped_mlp`` replaces ``repro/kernels/expert_mlp_grouped.py::grouped_mlp_kernel``
(the TPU kernel 4, weights in the input type); ``grouped_mlp_quant`` replaces
``::grouped_mlp_quant_kernel`` (kernel 5, MoQ int8 or int4 weights with f32
per-output-column scales, dequantized inside the kernel).  The design and
bound are in the source's note.  A tensor on the CPU takes the plain version;
a CUDA tensor launches the kernel or raises.  ``launches`` counts the
wrappers' kernel launches, so a run can show that its main path went through
the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.quant.qarrays import QuantizedArray, dequantize_values

TILE = 8  # token rows per tile; must equal dispatch_grouped.GROUPED_TILE
VEC = 4  # columns a kernel lane loads at once: D and F must be multiples
# F block of the TPU kernel (repro/kernels/expert_mlp.py BLOCK_F): the quant
# kernel's compatibility rule keeps it, so both packages pick the same path
BLOCK_F = 256

launches = {"grouped_mlp": 0, "grouped_mlp_quant": 0}

_C_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_C_ARGS_QUANT = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library():
    lib = build.load_library("grouped_mlp")
    for fn, args in ((lib.grouped_mlp_bf16, _C_ARGS), (lib.grouped_mlp_f32, _C_ARGS),
                     (lib.grouped_mlp_quant_bf16, _C_ARGS_QUANT),
                     (lib.grouped_mlp_quant_f32, _C_ARGS_QUANT)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def grouped_mlp_plain(
    xg: torch.Tensor,  # [Ct, D] — tile-padded, expert-sorted token buffer
    te: torch.Tensor,  # [Ct / TILE] int32 — tile -> expert id
    wi: torch.Tensor,  # [E, D, F]
    wg: torch.Tensor,  # [E, D, F]
    wo: torch.Tensor,  # [E, F, D]
    rows_used: Optional[torch.Tensor] = None,  # [1] int32
) -> torch.Tensor:
    """The kernel's function in PyTorch, as ``grouped_mlp_ref`` of the JAX
    package computes it, but looping over the distinct experts of ``te``
    instead of gathering ``wi[te]`` (at full width that gather would copy
    tens of GB).  f32 products, activation rounded to the input type."""
    return _experts_plain(xg, te, rows_used, lambda e: (wi[e], wg[e], wo[e]))


def _experts_plain(xg, te, rows_used, weights_of):
    """Loop over the distinct experts of the live tiles: ``weights_of(e)``
    gives expert e's (wi, wg, wo) in full precision."""
    Ct, D = xg.shape
    nt = te.shape[0]
    tile_e = te.long()
    live = torch.ones(nt, dtype=torch.bool, device=xg.device)
    if rows_used is not None:
        live = torch.arange(nt, device=xg.device) * (Ct // nt) < rows_used.to(xg.device)
    row_e = torch.where(live, tile_e, -1).repeat_interleave(Ct // nt)
    out = torch.zeros_like(xg)
    for e in torch.unique(tile_e[live]).tolist():
        wi, wg, wo = weights_of(e)
        rows = row_e == e
        x = xg[rows].float()
        h = x @ wi.float()
        g = x @ wg.float()
        act = (F.silu(g) * h).to(xg.dtype)
        out[rows] = (act.float() @ wo.float()).to(xg.dtype)
    return out


def _expert(w: QuantizedArray, e: int) -> torch.Tensor:
    """Expert e of a quantized [E, Din, Dout] leaf, dequantized to its
    original type."""
    return dequantize_values(w.q[e], w.scale[e], w.bits, w.group_size, w.axis, w.orig_dtype)


def grouped_mlp_quant_plain(
    xg: torch.Tensor,  # [Ct, D]
    te: torch.Tensor,  # [Ct / TILE] int32
    wi: QuantizedArray,  # [E, D, F] (stored [E, D/2, F] at int4)
    wg: QuantizedArray,
    wo: QuantizedArray,  # [E, F, D] (stored [E, F/2, D] at int4)
    rows_used: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 5's function in PyTorch, as ``grouped_mlp_quant_ref`` of the JAX
    package computes it: each touched expert dequantized to the original
    type (any group size), then the products of ``grouped_mlp_plain``.  The
    kernel rounds each dequantized weight to the activation type, the same
    value when the activations are in the weights' original type."""
    return _experts_plain(xg, te, rows_used, lambda e: (_expert(wi, e), _expert(wg, e), _expert(wo, e)))


def check_grouped_quant_compat(wi, wg, wo, *, block_f: int = BLOCK_F) -> bool:
    """Whether kernel 5 takes these weights (``_check_grouped_quant_compat`` of
    the JAX package): SwiGLU ``QuantizedArray`` triples with per-output-column
    scales (group_size 0) at 8 or 4 bits, equal bits, d_ff a multiple of the
    F block, even dims to unpack nibbles; plus this kernel's own layout
    rule, D and F multiples of 4."""
    qs = (wi, wg, wo)
    if wg is None or not all(isinstance(q, QuantizedArray) for q in qs):
        return False
    if not all(q.bits in (8, 4) and q.group_size == 0 for q in qs):
        return False
    bits = wi.bits
    if any(q.bits != bits for q in qs):
        return False
    Fd = wi.shape[-1]
    D = wo.shape[-1]
    bf = min(block_f, Fd)
    pack = 2 if bits == 4 else 1
    return Fd % bf == 0 and D % pack == 0 and bf % pack == 0 and D % VEC == 0 and Fd % VEC == 0


def _check(xg, te, wi, wg, wo, rows_used):
    dev = xg.device
    for name, t in (("te", te), ("wi", wi), ("wg", wg), ("wo", wo), ("rows_used", rows_used)):
        if t.device != dev:
            raise ValueError(f"grouped_mlp: {name} is on {t.device}, xg on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_mlp: {name} must be contiguous")
    if not xg.is_contiguous():
        raise ValueError("grouped_mlp: xg must be contiguous")
    if xg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"grouped_mlp: dtype {xg.dtype} not supported (bfloat16, float32)")
    for name, t in (("wi", wi), ("wg", wg), ("wo", wo)):
        if t.dtype != xg.dtype:
            raise TypeError(f"grouped_mlp: {name} is {t.dtype}, xg is {xg.dtype}")
    if te.dtype != torch.int32 or rows_used.dtype != torch.int32 or rows_used.numel() != 1:
        raise TypeError("grouped_mlp: te and rows_used must be int32, rows_used one element")
    Ct, D = xg.shape
    E, _, Fd = wi.shape
    if Ct % TILE or te.shape != (Ct // TILE,):
        raise ValueError(f"grouped_mlp: Ct={Ct} must be a multiple of {TILE} with one te entry per tile")
    if wi.shape != (E, D, Fd) or wg.shape != (E, D, Fd) or wo.shape != (E, Fd, D):
        raise ValueError(f"grouped_mlp: weight shapes {wi.shape} {wg.shape} {wo.shape} do not match D={D}")
    if D % VEC or Fd % VEC:
        raise ValueError(f"grouped_mlp: D={D} and F={Fd} must be multiples of {VEC}")


def grouped_mlp(
    xg: torch.Tensor,
    te: torch.Tensor,
    wi: torch.Tensor,
    wg: torch.Tensor,
    wo: torch.Tensor,
    rows_used: torch.Tensor,
) -> torch.Tensor:
    """[Ct, D] output of tile ``t``'s rows through expert ``te[t]``'s SwiGLU
    MLP.  ``rows_used`` ([1] int32 on the device, ``GroupedLayout.rows_used``):
    tiles at or past it hold no token and give zero rows without reading any
    weight."""
    if xg.device.type == "cpu":
        return grouped_mlp_plain(xg, te, wi, wg, wo, rows_used)
    if xg.device.type != "cuda":
        raise ValueError(f"grouped_mlp: no kernel for device {xg.device}")
    Ct, D = xg.shape
    Fd = wi.shape[-1]
    _check(xg, te, wi, wg, wo, rows_used)
    lib = _library()
    fn = lib.grouped_mlp_bf16 if xg.dtype == torch.bfloat16 else lib.grouped_mlp_f32
    act = torch.empty((Ct, Fd), dtype=xg.dtype, device=xg.device)
    out = torch.empty_like(xg)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xg.data_ptr(), te.data_ptr(), rows_used.data_ptr(), wi.data_ptr(),
                 wg.data_ptr(), wo.data_ptr(), act.data_ptr(), out.data_ptr(),
                 Ct // TILE, D, Fd, stream)
    if err != 0:
        raise RuntimeError(f"grouped_mlp: kernel launch failed with CUDA error {err}")
    launches["grouped_mlp"] += 1
    return out


def grouped_mlp_quant(
    xg: torch.Tensor,
    te: torch.Tensor,
    wi: QuantizedArray,
    wg: QuantizedArray,
    wo: QuantizedArray,
    rows_used: torch.Tensor,
) -> torch.Tensor:
    """``grouped_mlp`` over MoQ-quantized experts (kernel 5): int8, or int4
    packed along the contraction axes, with per-output-column scales
    (``check_grouped_quant_compat``)."""
    if xg.device.type == "cpu":
        return grouped_mlp_quant_plain(xg, te, wi, wg, wo, rows_used)
    if xg.device.type != "cuda":
        raise ValueError(f"grouped_mlp_quant: no kernel for device {xg.device}")
    if not check_grouped_quant_compat(wi, wg, wo):
        raise ValueError(
            "grouped_mlp_quant: the kernel takes int8/int4 per-output-column weights "
            f"(group_size 0) with d_ff a multiple of {BLOCK_F} or less; got bits "
            f"{getattr(wi, 'bits', None)}, group_size {getattr(wi, 'group_size', None)}")
    Ct, D = xg.shape
    E, _, Fd = wi.shape
    for name, t in (("te", te), ("rows_used", rows_used), ("wi", wi.q), ("wg", wg.q),
                    ("wo", wo.q), ("wi.scale", wi.scale), ("wg.scale", wg.scale),
                    ("wo.scale", wo.scale)):
        if t.device != xg.device:
            raise ValueError(f"grouped_mlp_quant: {name} is on {t.device}, xg on {xg.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_mlp_quant: {name} must be contiguous")
    if not xg.is_contiguous() or xg.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"grouped_mlp_quant: xg must be contiguous bfloat16 or float32, got {xg.dtype}")
    if te.dtype != torch.int32 or rows_used.dtype != torch.int32 or rows_used.numel() != 1:
        raise TypeError("grouped_mlp_quant: te and rows_used must be int32, rows_used one element")
    if Ct % TILE or te.shape != (Ct // TILE,):
        raise ValueError(f"grouped_mlp_quant: Ct={Ct} must be a multiple of {TILE} with one te entry per tile")
    if wi.shape != (E, D, Fd) or wg.shape != (E, D, Fd) or wo.shape != (E, Fd, D):
        raise ValueError(f"grouped_mlp_quant: weight shapes {wi.shape} {wg.shape} {wo.shape} do not match D={D}")
    for name, w, n in (("wi", wi, Fd), ("wg", wg, Fd), ("wo", wo, D)):
        if w.axis != -2 or w.scale.shape != (E, 1, n) or w.scale.dtype != torch.float32:
            raise ValueError(f"grouped_mlp_quant: {name} must be packed along its contraction "
                             f"axis with float32 scales [E, 1, {n}]")
    lib = _library()
    fn = lib.grouped_mlp_quant_bf16 if xg.dtype == torch.bfloat16 else lib.grouped_mlp_quant_f32
    act = torch.empty((Ct, Fd), dtype=xg.dtype, device=xg.device)
    out = torch.empty_like(xg)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xg.data_ptr(), te.data_ptr(), rows_used.data_ptr(), wi.q.data_ptr(),
                 wi.scale.data_ptr(), wg.q.data_ptr(), wg.scale.data_ptr(), wo.q.data_ptr(),
                 wo.scale.data_ptr(), act.data_ptr(), out.data_ptr(), Ct // TILE, D, Fd, wi.bits,
                 stream)
    if err != 0:
        raise RuntimeError(f"grouped_mlp_quant: kernel launch failed with CUDA error {err}")
    launches["grouped_mlp_quant"] += 1
    return out
