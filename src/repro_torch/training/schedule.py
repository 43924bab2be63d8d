"""LR schedules (``repro/training/schedule.py``; the paper's Table 1 recipe):
linear warmup, cosine decay to a floor, and the batch-size ramp-up as a
loss-mask fraction.  Each returns an f32 0-d tensor on the CPU, computed in
f32 in JAX's order; the trainer reads it on the host (no device sync)."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def warmup_cosine(step, *, warmup_steps: int, decay_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Multiplier in [min_ratio, 1]."""
    step = _f32(step)
    warm = torch.minimum(step / max(warmup_steps, 1), _f32(1.0))
    prog = torch.clamp((step - warmup_steps) / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi) * prog))
    decay = min_ratio + (1.0 - min_ratio) * cos
    return warm * decay


def batch_rampup(step, *, rampup_steps: int, start_frac: float = 0.25) -> torch.Tensor:
    """The fraction of the global batch to use (a loss mask, shapes static)."""
    if rampup_steps <= 0:
        return _f32(1.0)
    step = _f32(step)
    f = start_frac + (1.0 - start_frac) * torch.minimum(step / rampup_steps, _f32(1.0))
    return torch.minimum(f, _f32(1.0))
