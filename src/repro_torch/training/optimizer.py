"""AdamW as the JAX package writes it (``repro/training/optimizer.py``):
f32 first and second moments, global-norm clipping, bias correction from
the step, decoupled weight decay on leaves with ``ndim >= 2`` only, the
update made in f32 and cast to the parameter's type.

``torch.optim.AdamW`` decays every tensor and orders the arithmetic
differently, so it is not used.  The update is plain tensor code (JAX
computes it outside any Pallas kernel too), in place: parameters and
moments are updated where they lie, a leaf at a time in chunks of
``CHUNK`` values, so the f32 temporaries of a 1.3 G-value expert leaf stay
a few hundred MB.  Each chunk follows JAX's expression in its order of
roundings.  The sharded (ZeRO-1) moments of the JAX docstring belong to
expert-parallel training (ROADMAP queue 1 item 7b).

Trees here are ``{path: tensor}`` dicts in one order
(``models/model.py::param_leaves``); the step is a host integer.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

CHUNK = 1 << 26  # values of a leaf updated at a time


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class AdamWConfig(NamedTuple):
    lr: float = 1e-4  # peak; multiplied by schedule(step)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_adamw(params: Dict[str, torch.Tensor]) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(0, {k: zeros(p) for k, p in params.items()},
                      {k: zeros(p) for k, p in params.items()})


def _chunks(t: torch.Tensor):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i : i + CHUNK]


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a 0-d
    f32 tensor on the leaves' device; no host sync)."""
    total = None
    for leaf in tree.values():
        s = sum(torch.sum(torch.square(c.float())) for c in _chunks(leaf))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _f32_scalar(x) -> float:
    """A value rounded to f32, as a Python float (JAX's weak-typed scalars
    meet f32 arrays in f32)."""
    return torch.tensor(x, dtype=torch.float32).item()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], lr_scale) -> tuple:
    """One AdamW step.  ``params`` and the moments are updated in place;
    returns (params, new state, {"grad_norm": 0-d tensor}), the JAX
    function's triple.  ``lr_scale``: the schedule's multiplier."""
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip > 0
            else None)
    step = state.step + 1
    stepf = torch.tensor(float(step), dtype=torch.float32)
    b1c = (1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf).item()
    b2c = (1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf).item()
    lr = (torch.tensor(cfg.lr, dtype=torch.float32) * torch.as_tensor(lr_scale, dtype=torch.float32)
          .cpu()).item()
    b1, b2 = _f32_scalar(cfg.b1), _f32_scalar(cfg.b2)
    one_b1, one_b2 = _f32_scalar(1 - cfg.b1), _f32_scalar(1 - cfg.b2)
    eps, wd = _f32_scalar(cfg.eps), _f32_scalar(cfg.weight_decay)
    for key, p in params.items():
        decay = p.dim() >= 2
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(grads[key]), _chunks(state.m[key]),
                                  _chunks(state.v[key])):
            g = gc.float()
            if clip is not None:
                g = g * clip
            mc.mul_(b1).add_(g * one_b1)  # m_ = b1 m + (1 - b1) g
            vc.mul_(b2).add_((g * one_b2).mul_(g))  # v_ = b2 v + (1 - b2) g g
            denom = (vc / b2c).sqrt_().add_(eps)  # sqrt(vhat) + eps
            delta = (mc / b1c).div_(denom)
            p32 = pc.float()
            if decay:  # decoupled weight decay on matrices only
                delta.add_(p32 * wd)
            pc.copy_(p32.sub_(delta.mul_(lr)))
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
