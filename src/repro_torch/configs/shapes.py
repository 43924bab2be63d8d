"""Assigned input shapes (public pool) and which entry point each runs: a
copy of ``repro/configs/shapes.py``, kept in sync by hand."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg, shape: InputShape) -> tuple[bool, str]:
    """Does this (arch, shape) pair run?  long_500k needs sub-quadratic decode
    support (sliding-window / SSM / LRU) — pure full-attention archs skip it
    (as the JAX package documents)."""
    if shape.kind == "decode" and shape.seq_len > cfg.max_seq_len:
        if not cfg.supports_long_context:
            return False, f"{cfg.name}: full-attention arch, no sub-quadratic path for {shape.name}"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, f"{cfg.name}: full-attention arch, long_500k skipped"
    return True, ""
