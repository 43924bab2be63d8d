"""The guard of the kernels that have no backward.

Only kernels 6 and 1 (flash attention and capacity gating) have a backward
kernel (6b, 1b).  The expert kernels 2-5 get theirs with SwiGLU-MoE
training (ROADMAP queue 1 item 7, expert-parallel training: no SwiGLU-MoE
config of the registry trains on one card), and the serving kernels 7-9
have none.  A ctypes launch's output carries no gradient, so without this
guard a forward under grad would cut the gradient of every weight behind
it without an error.  Each of those wrappers calls ``refuse_grad`` on its
CUDA path, before it launches.
"""
from __future__ import annotations

import torch

EXPERT_KERNELS = "ROADMAP queue 1 item 7 (expert-parallel training) gives it a backward"
SERVING_KERNELS = "a serving kernel: no ROADMAP item gives it a backward"


def refuse_grad(name: str, why: str, *tensors) -> None:
    """Raise where grad is enabled and one of ``tensors`` (None allowed)
    requires it: ``name``'s kernel has no backward (``why``)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward ({why}); run it under "
                           "torch.no_grad(), or train through a path whose kernels have one")


def quant_tensors(*weights):
    """The tensors of quantized weights that could require grad (their
    float scales; the int8 values cannot)."""
    return [getattr(w, "scale", None) for w in weights]
