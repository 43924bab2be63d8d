"""Fused MoE gating with expert capacity: the wrapper of the hand-written
Hopper kernel ``csrc/moe_gating.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/moe_gating.py::gating_kernel`` (the TPU
kernel 1) and computes ``core/gating.py::top_k_gating``'s contract: f32
softmax, top-k with ties to the lower expert id, token-major positions in
each expert's capacity buffer, renormalised gates for K > 1, drops past the
capacity.  It also returns the per-expert assignment counts on the device,
which the capacity-buffer expert kernels read to skip empty experts (no host
sync).  The design and bound are in the source's note.  A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises.
``launches`` counts the wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.gating import Gating, count_ids, top_k_gating
from repro_torch.kernels import build

MAX_EXPERTS = 512  # 16 values per lane of the token's warp
MAX_TOP_K = 32  # gate k lives in lane k

launches = {"moe_gating": 0}

_C_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _library():
    lib = build.load_library("moe_gating")
    lib.moe_gating_f32.argtypes = _C_ARGS
    lib.moe_gating_f32.restype = ctypes.c_int
    return lib


def gating_plain(logits: torch.Tensor, top_k: int, capacity: int, *,
                 normalize: bool = True) -> Tuple[Gating, torch.Tensor]:
    """The kernel's function in PyTorch: ``top_k_gating`` (iterative masked
    argmax, so ties go to the lower id as in JAX; ranks by a stable sort),
    and the per-expert counts [E] int32 of all assignments."""
    g = top_k_gating(logits, top_k, capacity, normalize=normalize)
    return g, count_ids(g.expert_idx, logits.shape[-1]).to(torch.int32)


def gating(logits: torch.Tensor, top_k: int, capacity: int, *,
           normalize: bool = True) -> Tuple[Gating, torch.Tensor]:
    """logits [T, E] -> (``Gating``, counts [E] int32).  ``counts[e]`` is the
    number of (token, k) slots routed to expert e before capacity, so
    ``min(counts, capacity)`` rows of its buffer hold tokens."""
    if logits.device.type == "cpu":
        return gating_plain(logits, top_k, capacity, normalize=normalize)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: no kernel for device {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32 or not logits.is_contiguous():
        raise TypeError(f"moe_gating: logits must be a contiguous [T, E] float32 tensor, got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    T, E = logits.shape
    if not (1 <= top_k <= min(E, MAX_TOP_K)) or E > MAX_EXPERTS or capacity < 1 or T < 1:
        raise ValueError(f"moe_gating: the kernel takes E <= {MAX_EXPERTS}, 1 <= top_k <= "
                         f"min(E, {MAX_TOP_K}), capacity >= 1; got T={T}, E={E}, top_k={top_k}, "
                         f"capacity={capacity}")
    dev = logits.device
    probs = torch.empty((T, E), dtype=torch.float32, device=dev)
    eidx = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    w = torch.empty((T, top_k), dtype=torch.float32, device=dev)
    pos = torch.empty((T, top_k), dtype=torch.int32, device=dev)
    keep = torch.empty((T, top_k), dtype=torch.bool, device=dev)
    counts = torch.empty((E,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_gating_f32(logits.data_ptr(), probs.data_ptr(), eidx.data_ptr(), w.data_ptr(),
                                 pos.data_ptr(), keep.data_ptr(), counts.data_ptr(), T, E, top_k,
                                 capacity, int(normalize), stream)
    if err != 0:
        raise RuntimeError(f"moe_gating: kernel launch failed with CUDA error {err}")
    launches["moe_gating"] += 1
    return Gating(eidx, w, pos, keep, probs), counts
