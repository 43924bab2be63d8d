"""Expert SwiGLU MLP over the capacity buffer with MoQ int8 weights: the
wrapper of the hand-written Hopper kernels (``csrc/grouped_mlp_mma.cu``, the
tensor-core kernel over the capacity layout, for bf16 activations at widths
it takes; ``csrc/grouped_mlp.cu``, its CUDA-core int8 capacity entry points,
for f32 activations and other widths) and their plain PyTorch versions.

The kernels replace ``repro/kernels/expert_mlp_quant.py::expert_mlp_quant_kernel``
(the TPU kernel 3).  The CUDA-core kernel, like the TPU kernel, widens each
int8 weight, multiplies it by its f32 column scale and rounds it to the
activation type before its product (``expert_mlp_quant_plain``, the CPU
path); the tensor-core kernel sums the integer weights' products in f32 and
multiplies the sum by the column scale once (``expert_mlp_quant_mma_plain``),
as kernel 5's does.  ``kernel_variant`` (``expert_mlp_grouped``) picks one
from the dtype and the widths alone.  ``check_kernel_compat`` takes the
layout part of the JAX package's rule (int8 per output column) and this
kernel's own shape rule; other layouts (int4, group-wise scales) take the
plain dequantize path in ``core/moe.py``, as they do in JAX.  The TPU grid's
rule that C and F divide into its 128 / 256 blocks does not apply: the
kernels take any C that is a multiple of 8, as ``expert_capacity`` gives.
A tensor on the CPU takes the plain version; a CUDA tensor launches a kernel
or raises.  ``launches`` counts the wrapper's kernel launches and
``variant_launches`` which kernel each took.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.expert_mlp import check_buffer, check_fill, experts_plain, library
from repro_torch.kernels.expert_mlp_grouped import (TILE, VEC, _expert, kernel_variant,
                                                    launch_capacity_mma)
from repro_torch.quant.qarrays import QuantizedArray, dequantize_values
from repro_torch.kernels.no_backward import EXPERT_KERNELS, quant_tensors, refuse_grad

launches = {"expert_mlp_quant": 0}
variant_launches = {"expert_mlp_quant_mma": 0, "expert_mlp_quant_fma": 0}


def check_kernel_compat(xe, wi, wg, wo) -> bool:
    """Whether the kernel takes these weights: int8 per-output-column SwiGLU
    ``QuantizedArray`` triples (group_size 0), the layout that the JAX
    package's ``_check_kernel_compat`` asks for; C a multiple of 8, D and F
    multiples of 4."""
    qs = (wi, wg, wo)
    if wg is None or not all(isinstance(q, QuantizedArray) for q in qs):
        return False
    if not all(q.bits == 8 and q.group_size == 0 for q in qs):
        return False
    C, D = xe.shape[1], xe.shape[2]
    Fd = wi.shape[-1]
    return C % TILE == 0 and D % VEC == 0 and Fd % VEC == 0


def expert_mlp_quant_plain(xe, wi: QuantizedArray, wg: QuantizedArray, wo: QuantizedArray,
                           fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``expert_mlp_quant_ref``'s function: each expert dequantized to the
    weights' original type (any bits and group size), then
    ``expert_mlp_plain``'s products.  The CUDA-core kernel rounds each
    dequantized weight to the activation type, the same value when the
    activations are in the weights' original type."""
    return experts_plain(xe, fill, lambda e: (_expert(wi, e), _expert(wg, e), _expert(wo, e)))


def expert_mlp_quant_mma_plain(xe, wi: QuantizedArray, wg: QuantizedArray, wo: QuantizedArray,
                               fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 3's function in the tensor-core kernel's order: the integer
    weights times the activations summed in f32, then times each output
    column's scale once, ``(x . q) * s`` (per-output-column scales only),
    where ``expert_mlp_quant_plain`` rounds every dequantized weight to the
    weights' type first."""
    def values(w, e):  # the integers, unscaled
        return dequantize_values(w.q[e], torch.ones_like(w.scale[e]), w.bits, 0, w.axis, torch.float32)

    return experts_plain(xe, fill, lambda e: (values(wi, e), values(wg, e), values(wo, e)),
                         lambda e: (wi.scale[e], wg.scale[e], wo.scale[e]))


def expert_mlp_quant(
    xe: torch.Tensor,  # [E, C, D]
    wi: QuantizedArray,  # [E, D, F] int8, scales [E, 1, F]
    wg: QuantizedArray,
    wo: QuantizedArray,  # [E, F, D] int8, scales [E, 1, D]
    fill: Optional[torch.Tensor] = None,  # [E] int32
    n_assign: Optional[int] = None,
) -> torch.Tensor:
    """``expert_mlp`` over int8 per-output-column experts (kernel 3).
    ``n_assign``: the assignments the buffer can hold at most (the MoE
    layer's T*K, a static shape value), which bounds the tensor-core
    kernel's grid (``capacity_mma_plan``); None if unknown."""
    if xe.device.type == "cpu":
        return expert_mlp_quant_plain(xe, wi, wg, wo, fill)
    if xe.device.type != "cuda":
        raise ValueError(f"expert_mlp_quant: no kernel for device {xe.device}")
    refuse_grad("expert_mlp_quant", EXPERT_KERNELS, xe, *quant_tensors(wi, wg, wo))
    if not check_kernel_compat(xe, wi, wg, wo):
        raise ValueError(
            "expert_mlp_quant: the kernel takes int8 per-output-column weights (group_size 0) "
            f"with C a multiple of {TILE}, D and F of {VEC}; got bits "
            f"{getattr(wi, 'bits', None)}, group_size {getattr(wi, 'group_size', None)}, "
            f"C={xe.shape[1]}, F={getattr(wi, 'shape', (None,))[-1]}")
    E, C, D = xe.shape
    Fd = wi.shape[-1]
    check_buffer("expert_mlp_quant", xe, Fd)
    fill = check_fill("expert_mlp_quant", xe, fill)
    for name, w, shape, n in (("wi", wi, (E, D, Fd), Fd), ("wg", wg, (E, D, Fd), Fd),
                              ("wo", wo, (E, Fd, D), D)):
        if tuple(w.shape) != shape or w.axis != -2 or w.scale.shape != (E, 1, n) \
                or w.scale.dtype != torch.float32:
            raise ValueError(f"expert_mlp_quant: {name} must be {shape} quantized along its "
                             f"contraction axis with float32 scales [E, 1, {n}]")
        for part, t in (("q", w.q), ("scale", w.scale)):
            if t.device != xe.device or not t.is_contiguous():
                raise ValueError(f"expert_mlp_quant: {name}.{part} must be contiguous on {xe.device}")
    variant = kernel_variant(xe.dtype, D, Fd, 8)
    if variant == "mma":
        out = launch_capacity_mma(xe, fill, (wi.q, wi.scale), (wg.q, wg.scale), (wo.q, wo.scale),
                                  "expert_mlp_quant", n_assign)
    else:
        lib = library()
        fn = lib.expert_mlp_quant_bf16 if xe.dtype == torch.bfloat16 else lib.expert_mlp_quant_f32
        act = torch.empty((E * C, Fd), dtype=xe.dtype, device=xe.device)
        out = torch.empty_like(xe)
        with torch.cuda.device(xe.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(xe.data_ptr(), fill.data_ptr(), wi.q.data_ptr(), wi.scale.data_ptr(),
                     wg.q.data_ptr(), wg.scale.data_ptr(), wo.q.data_ptr(), wo.scale.data_ptr(),
                     act.data_ptr(), out.data_ptr(), E, C, D, Fd, stream)
        if err != 0:
            raise RuntimeError(f"expert_mlp_quant: kernel launch failed with CUDA error {err}")
    launches["expert_mlp_quant"] += 1
    variant_launches[f"expert_mlp_quant_{variant}"] += 1
    return out
