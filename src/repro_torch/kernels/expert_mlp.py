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

Training: ``expert_mlp`` under grad is ``ExpertMlpFn``, kernel 2 forward and
kernel 2b (``csrc/grouped_mlp_bwd.cu``, the device code of kernel 4b over
the capacity layout) backward, or their plain versions on the CPU
(``expert_mlp_backward_plain``).  Rows at or past ``min(fill[e], C)`` are
dead: dx = 0 there and they add nothing to the weight gradients.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.expert_mlp_grouped import TILE, VEC, launch_backward, swiglu_backward_rows
from repro_torch.kernels import account

launches = {"expert_mlp": 0, "expert_mlp_backward": 0}

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
    # analysis: allow(host-asarray) — plain version, CPU only
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


def check_weights(name: str, xe: torch.Tensor, wi, wg, wo) -> None:
    E, C, D = xe.shape
    Fd = wi.shape[-1]
    for n, t, shape in (("wi", wi, (E, D, Fd)), ("wg", wg, (E, D, Fd)), ("wo", wo, (E, Fd, D))):
        if t.device != xe.device or t.dtype != xe.dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous {xe.dtype} {shape} tensor "
                             f"on {xe.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def expert_mlp(
    xe: torch.Tensor,  # [E, C, D] — the capacity buffer
    wi: torch.Tensor,  # [E, D, F]
    wg: torch.Tensor,  # [E, D, F]
    wo: torch.Tensor,  # [E, F, D]
    fill: Optional[torch.Tensor] = None,  # [E] int32 — rows of each buffer that hold tokens
) -> torch.Tensor:
    """[E, C, D]: row c of expert e through expert e's SwiGLU MLP.  Rows at
    or past ``fill[e]`` must be zero (as the dispatch leaves them); the
    kernel writes zeros for them without reading a weight.  Differentiable
    (``ExpertMlpFn``) when grad is enabled and xe or a weight requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xe, wi, wg, wo)):
        return ExpertMlpFn.apply(xe, wi, wg, wo, fill)
    return _expert_mlp(xe, wi, wg, wo, fill)


class ExpertMlpFn(torch.autograd.Function):
    """Kernel 2 forward, kernel 2b backward (plain versions on the CPU);
    saves the inputs only: the backward recomputes u, g and a."""

    @staticmethod
    def forward(ctx, xe, wi, wg, wo, fill):
        ctx.save_for_backward(xe, wi, wg, wo, fill)
        return _expert_mlp(xe, wi, wg, wo, fill)

    @staticmethod
    def backward(ctx, dy):
        xe, wi, wg, wo, fill = ctx.saved_tensors
        dx, dwi, dwg, dwo = expert_mlp_backward(xe, wi, wg, wo, dy.contiguous(), fill)
        return dx, dwi, dwg, dwo, None


def expert_mlp_backward_plain(xe, wi, wg, wo, dy, fill=None):
    """Kernel 2b's function in PyTorch: (dxe, dwi, dwg, dwo) of
    ``expert_mlp`` at output gradient ``dy`` [E, C, D], one expert at a time
    over its live rows, the first ``min(fill[e], C)`` (all C without
    ``fill``), by ``swiglu_backward_rows``: explicit formulas, not autograd.
    Dead rows get dx = 0; an expert with no live row gets zero weight
    gradients."""
    E, C, _ = xe.shape
    live = [C] * E if fill is None else fill.cpu().long().clamp(0, C).tolist()
    dx = torch.zeros_like(xe)
    grads = [torch.zeros_like(w) for w in (wi, wg, wo)]
    for e in range(E):
        n = live[e]
        if n == 0:
            continue
        gx, *gw = swiglu_backward_rows(xe[e, :n], dy[e, :n], wi[e], wg[e], wo[e], xe.dtype)
        dx[e, :n] = gx.to(xe.dtype)
        for out, g in zip(grads, gw):
            out[e] = g.to(out.dtype)
    return (dx, *grads)


def expert_mlp_backward(xe, wi, wg, wo, dy, fill=None):
    """(dxe, dwi, dwg, dwo) of ``expert_mlp`` at ``dy``: kernel 2b on the
    card (one count a call: its table kernel, row passes and weight passes;
    the fill cut to C, as the forward cuts it), the plain version on the
    CPU."""
    if account.recorder is not None:
        return account.recorder.kernel("expert_mlp_backward", expert_mlp_backward, **locals())
    if xe.device.type == "cpu":
        return expert_mlp_backward_plain(xe, wi, wg, wo, dy, fill)
    if xe.device.type != "cuda":
        raise ValueError(f"expert_mlp_backward: no kernel for device {xe.device}")
    name = "expert_mlp_backward"
    check_buffer(name, xe, wi.shape[-1])
    fill = check_fill(name, xe, fill)
    check_weights(name, xe, wi, wg, wo)
    out = launch_backward(name, xe, wi, wg, wo, dy, fill=fill)
    launches[name] += 1
    return out


def _expert_mlp(xe, wi, wg, wo, fill):
    """Kernel 2 (its plain version on the CPU)."""
    if account.recorder is not None:
        return account.recorder.kernel("expert_mlp", _expert_mlp, **locals())
    if xe.device.type == "cpu":
        return expert_mlp_plain(xe, wi, wg, wo, fill)
    if xe.device.type != "cuda":
        raise ValueError(f"expert_mlp: no kernel for device {xe.device}")
    E, C, D = xe.shape
    Fd = wi.shape[-1]
    check_buffer("expert_mlp", xe, Fd)
    fill = check_fill("expert_mlp", xe, fill)
    check_weights("expert_mlp", xe, wi, wg, wo)
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
