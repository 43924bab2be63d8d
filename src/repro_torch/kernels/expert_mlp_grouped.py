"""Grouped (dropless) expert SwiGLU MLP: the wrapper of the hand-written
Hopper kernel ``csrc/grouped_mlp.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/expert_mlp_grouped.py::grouped_mlp_kernel``
(the TPU kernel); its design and bound are in the source's note.  A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or raises.
``launches`` counts the wrapper's kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

TILE = 8  # token rows per tile; must equal dispatch_grouped.GROUPED_TILE
VEC = 4  # columns a kernel lane loads at once: D and F must be multiples

launches = {"grouped_mlp": 0}

_C_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _library():
    lib = build.load_library("grouped_mlp")
    for fn in (lib.grouped_mlp_bf16, lib.grouped_mlp_f32):
        fn.argtypes = _C_ARGS
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
    Ct, D = xg.shape
    nt = te.shape[0]
    tile_e = te.long()
    live = torch.ones(nt, dtype=torch.bool, device=xg.device)
    if rows_used is not None:
        live = torch.arange(nt, device=xg.device) * (Ct // nt) < rows_used.to(xg.device)
    row_e = torch.where(live, tile_e, -1).repeat_interleave(Ct // nt)
    out = torch.zeros_like(xg)
    for e in torch.unique(tile_e[live]).tolist():
        rows = row_e == e
        x = xg[rows].float()
        h = x @ wi[e].float()
        g = x @ wg[e].float()
        act = (F.silu(g) * h).to(xg.dtype)
        out[rows] = (act.float() @ wo[e].float()).to(xg.dtype)
    return out


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
