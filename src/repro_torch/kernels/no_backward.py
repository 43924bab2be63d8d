"""The guard of the kernels that have no backward.

Kernels 6 and 1 (flash attention and capacity gating) have backward kernels
(6b, 1b), and so do the fp SwiGLU expert kernels 2 and 4 (2b, 4b:
``csrc/grouped_mlp_bwd.cu``, through ``ExpertMlpFn`` / ``GroupedMlpFn``).
The quantized expert kernels 3 and 5 serve MoQ weights, which are made
after training (``quant/ptq.py``) and which nothing trains, and the serving
kernels 7-9 have no backward either.  A ctypes launch's output carries no
gradient, so without this guard a forward under grad would cut the
gradient of every weight behind it without an error.  Each of those
wrappers calls ``refuse_grad`` on its CUDA path, before it launches.
"""
from __future__ import annotations

import torch

EXPERT_KERNELS = ("a quantized (MoQ) expert kernel: MoQ weights are post-training and no ROADMAP "
                  "item trains them; fp experts train through kernels 2b and 4b")
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
