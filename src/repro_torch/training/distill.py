"""Mixture-of-Students: MoE-to-MoE knowledge distillation with staged KD
(``repro/training/distill.py``; DeepSpeed-MoE §4.2).

Loss (Eq. 1): L = CE(x; θ) + α · KL(teacher ∥ student) (+ the MoE aux
loss).  Staged KD: α is multiplied by (step < kd_stop_step), so KD stops
partway through training, which the paper finds recovers the benefit a
capacity-reduced student loses under full-run KD.  The teacher runs under
``torch.no_grad`` (JAX's ``stop_gradient``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward, trainable
from repro_torch.training.trainer import (
    TrainConfig,
    adamw_config,
    apply_grads,
    cross_entropy,
    moe_aux_coef,
)


@dataclass
class KDConfig:
    alpha: float = 1.0  # KD loss weight
    temperature: float = 1.0
    kd_stop_step: int = -1  # -1 = never stop ("full KD" baseline in Table 5)


def kd_alpha(kdc: KDConfig, step) -> torch.Tensor:
    """α, times (step < kd_stop_step) when KD is staged (f32 0-d)."""
    a = torch.tensor(kdc.alpha, dtype=torch.float32)
    if kdc.kd_stop_step >= 0:
        a = a * float(int(step) < kdc.kd_stop_step)
    return a


def kd_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor, tau: float) -> torch.Tensor:
    """KL(teacher ∥ student) with temperature, mean over tokens."""
    t = torch.log_softmax(teacher_logits.float() / tau, dim=-1)
    s = torch.log_softmax(student_logits.float() / tau, dim=-1)
    kl = torch.sum(torch.exp(t) * (t - s), dim=-1)
    return torch.mean(kl) * tau ** 2


def make_distill_step(student_cfg: ModelConfig, teacher_cfg: ModelConfig, tc: TrainConfig,
                      kdc: KDConfig) -> Callable:
    """step(params, opt_state, teacher_params, tokens, labels) -> (params,
    opt_state, metrics): ce, kl, aux, loss, kd_alpha, grad_norm, lr_scale."""
    opt = adamw_config(tc)

    def step_fn(params, opt_state, teacher_params, tokens, labels):
        with torch.no_grad():
            t_logits, _ = forward(teacher_cfg, teacher_params, tokens)
        a = kd_alpha(kdc, opt_state.step)
        leaves = trainable(params)
        with torch.enable_grad():
            s_logits, aux = forward(student_cfg, params, tokens)
            ce = cross_entropy(s_logits, labels)
            kl = kd_kl(s_logits, t_logits, kdc.temperature)
            loss = ce + a.to(kl.device) * kl + moe_aux_coef(student_cfg) * aux
        del t_logits
        opt_state, stats = apply_grads(opt, tc, leaves, loss, opt_state)
        metrics = {"ce": ce.detach(), "kl": kl.detach(), "aux": aux.detach(),
                   "loss": loss.detach(), "kd_alpha": a, **stats}
        return params, opt_state, metrics

    return step_fn


def make_student_config(teacher: ModelConfig, depth_ratio: float = 0.875) -> ModelConfig:
    """Depth-reduce a teacher (paper: 24 -> 21 layers, 12.5% off) by trimming
    segment repeats from the top, preserving the MoE/dense interleave."""
    target = max(1, round(teacher.num_layers * depth_ratio))
    drop = teacher.num_layers - target
    segs = list(teacher.segments)
    out = []
    for seg in reversed(segs):
        if drop <= 0:
            out.append(seg)
            continue
        take_layers = max(seg.num_layers - drop, 0)
        drop -= seg.num_layers - take_layers
        reps = take_layers // len(seg.pattern)
        rem = take_layers % len(seg.pattern)
        if reps:
            out.append(type(seg)(seg.pattern, reps))
        if rem:
            out.append(type(seg)(seg.pattern[:rem], 1))
    return teacher.replace(segments=tuple(reversed(out)), name=teacher.name + "-mos")
