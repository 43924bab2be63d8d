"""Expert SwiGLU MLP over the capacity buffer ``[E, C, D]`` that the dense
mapping-table and einsum dispatches fill: the wrapper of the hand-written
Hopper kernel (``csrc/grouped_mlp.cu``, its capacity entry points) and its
plain PyTorch version.

The kernel replaces ``repro/kernels/expert_mlp.py::expert_mlp_kernel`` (the
TPU kernel 2) and computes ``repro/kernels/ref.py::expert_mlp_ref``'s
function: h and g in f32, ``silu(g) * h`` rounded to the input type, the
down-projection summed in f32 and cast.  (The JAX package's fp
``experts_ffn`` einsums round h and g to the input type before the
activation; in f32 the two agree to summation order, in bf16 they differ by
those roundings.)  It shares its device code with kernel 4; ``fill`` [E]
int32 (the gating kernel's counts) lets it skip the tiles of rows no token
fills, so a decode step reads only the experts it routes to.  A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.  ``launches`` counts the wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.expert_mlp_grouped import TILE, VEC
from repro_torch.kernels.no_backward import EXPERT_KERNELS, refuse_grad

launches = {"expert_mlp": 0}

C_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
C_ARGS_QUANT = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def library():
    """The library of ``csrc/grouped_mlp.cu`` with the capacity entry points
    of kernels 2 and 3 bound."""
    lib = build.load_library("grouped_mlp")
    for fn, args in ((lib.expert_mlp_bf16, C_ARGS), (lib.expert_mlp_f32, C_ARGS),
                     (lib.expert_mlp_quant_bf16, C_ARGS_QUANT),
                     (lib.expert_mlp_quant_f32, C_ARGS_QUANT)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def experts_plain(xe: torch.Tensor, fill: Optional[torch.Tensor], weights_of,
                  scales_of=None) -> torch.Tensor:
    """``expert_mlp_ref``'s function, one expert at a time (at full width an
    einsum over every expert in f32 would widen tens of GB at once):
    ``weights_of(e)`` gives expert e's (wi, wg, wo); ``scales_of(e)``, if
    given, their per-column scales, which multiply each f32 sum.  With
    ``fill``, experts whose buffer holds no token are skipped; their rows
    are zero and give zero rows, so the result is the same."""
    E = xe.shape[0]
    out = torch.zeros_like(xe)
    live = range(E) if fill is None else torch.nonzero(fill > 0).flatten().tolist()
    for e in live:
        wi, wg, wo = weights_of(e)
        si, sg, so = scales_of(e) if scales_of is not None else (1.0, 1.0, 1.0)
        x = xe[e].float()
        act = (F.silu((x @ wg.float()) * sg) * ((x @ wi.float()) * si)).to(xe.dtype)
        out[e] = ((act.float() @ wo.float()) * so).to(xe.dtype)
    return out


def expert_mlp_plain(xe, wi, wg, wo, fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch (``expert_mlp_ref``)."""
    return experts_plain(xe, fill, lambda e: (wi[e], wg[e], wo[e]))


def check_fill(name: str, xe: torch.Tensor, fill: Optional[torch.Tensor]) -> torch.Tensor:
    """``fill`` as the kernel reads it: [E] int32 on xe's device; None means
    every row may hold a token."""
    E, C, _ = xe.shape
    if fill is None:
        return torch.full((E,), C, dtype=torch.int32, device=xe.device)
    if fill.device != xe.device or fill.dtype != torch.int32 or fill.shape != (E,) \
            or not fill.is_contiguous():
        raise ValueError(f"{name}: fill must be a contiguous [E={E}] int32 tensor on {xe.device}")
    return fill


def check_buffer(name: str, xe: torch.Tensor, Fd: int) -> None:
    if xe.dim() != 3 or not xe.is_contiguous() or xe.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: xe must be a contiguous [E, C, D] bfloat16 or float32 tensor, "
                        f"got {xe.dtype} {tuple(xe.shape)}")
    _, C, D = xe.shape
    if C % TILE or D % VEC or Fd % VEC:
        raise ValueError(f"{name}: C={C} must be a multiple of {TILE}, D={D} and F={Fd} of {VEC}")


def expert_mlp(
    xe: torch.Tensor,  # [E, C, D] — the capacity buffer
    wi: torch.Tensor,  # [E, D, F]
    wg: torch.Tensor,  # [E, D, F]
    wo: torch.Tensor,  # [E, F, D]
    fill: Optional[torch.Tensor] = None,  # [E] int32 — rows of each buffer that hold tokens
) -> torch.Tensor:
    """[E, C, D]: row c of expert e through expert e's SwiGLU MLP.  Rows at
    or past ``fill[e]`` must be zero (as the dispatch leaves them); the
    kernel writes zeros for them without reading a weight."""
    if xe.device.type == "cpu":
        return expert_mlp_plain(xe, wi, wg, wo, fill)
    if xe.device.type != "cuda":
        raise ValueError(f"expert_mlp: no kernel for device {xe.device}")
    refuse_grad("expert_mlp", EXPERT_KERNELS, xe, wi, wg, wo)
    E, C, D = xe.shape
    Fd = wi.shape[-1]
    check_buffer("expert_mlp", xe, Fd)
    fill = check_fill("expert_mlp", xe, fill)
    for name, t, shape in (("wi", wi, (E, D, Fd)), ("wg", wg, (E, D, Fd)), ("wo", wo, (E, Fd, D))):
        if t.device != xe.device or t.dtype != xe.dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"expert_mlp: {name} must be a contiguous {xe.dtype} {shape} tensor "
                             f"on {xe.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = library()
    fn = lib.expert_mlp_bf16 if xe.dtype == torch.bfloat16 else lib.expert_mlp_f32
    act = torch.empty((E * C, Fd), dtype=xe.dtype, device=xe.device)
    out = torch.empty_like(xe)
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xe.data_ptr(), fill.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
                 act.data_ptr(), out.data_ptr(), E, C, D, Fd, stream)
    if err != 0:
        raise RuntimeError(f"expert_mlp: kernel launch failed with CUDA error {err}")
    launches["expert_mlp"] += 1
    return out
