"""Token sampling (``repro/serving/sampling.py``): greedy, temperature, top-k
and top-p (nucleus) filtering; top-k and top-p compose (k first, then p).
Draws come from a ``torch.Generator`` and so differ from JAX's; the masks are
the same."""
from __future__ import annotations

from typing import Optional

import torch

_MASKED = -1e30


def _top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    cut = torch.topk(logits, top_k, dim=-1).values[:, -1:]
    return torch.where(logits < cut, torch.full((), _MASKED, device=logits.device), logits)


def _top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest set of tokens whose probability mass >= top_p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i stays if the mass strictly before it is < top_p
    keep = cum - probs < top_p
    n_keep = torch.clamp(keep.sum(dim=-1, keepdim=True), min=1)
    cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits < cutoff, torch.full((), _MASKED, device=logits.device), logits)


def sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int32)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        logits = _top_k_mask(logits, top_k)
    if 0.0 < top_p < 1.0:
        logits = _top_p_mask(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
