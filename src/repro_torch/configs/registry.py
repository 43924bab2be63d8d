"""Architecture registry: the 10 assigned architectures + the paper's own
NLG/MoE model zoo, and the reduced-variant builder used by smoke tests."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
    deepseek_67b,
    gemma3_27b,
    glm4_9b,
    internvl2_1b,
    kimi_k2_1t_a32b,
    llama3_8b,
    llama4_maverick_400b_a17b,
    mamba2_370m,
    recurrentgemma_2b,
    seamless_m4t_medium,
)
from repro_torch.configs.base import (
    AttnSpec,
    EncoderConfig,
    FFNSpec,
    FrontendSpec,
    LayerSpec,
    LRUSpec,
    ModelConfig,
    Segment,
    SSMSpec,
)
from repro_torch.configs.prmoe import paper_models

ASSIGNED = [
    "gemma3-27b",
    "glm4-9b",
    "llama4-maverick-400b-a17b",
    "kimi-k2-1t-a32b",
    "deepseek-67b",
    "mamba2-370m",
    "llama3-8b",
    "recurrentgemma-2b",
    "seamless-m4t-medium",
    "internvl2-1b",
]

_MODULES = {
    "gemma3-27b": gemma3_27b,
    "glm4-9b": glm4_9b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "deepseek-67b": deepseek_67b,
    "mamba2-370m": mamba2_370m,
    "llama3-8b": llama3_8b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "internvl2-1b": internvl2_1b,
}


def all_configs() -> Dict[str, ModelConfig]:
    out = {name: mod.config() for name, mod in _MODULES.items()}
    out.update(paper_models())
    return out


def get_config(name: str) -> ModelConfig:
    cfgs = all_configs()
    if name not in cfgs:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(cfgs)}")
    return cfgs[name]


# ---------------------------------------------------------------------------
# Reduced variants (smoke tests: ≤2-ish layers, d_model≤512, ≤4 experts)
# ---------------------------------------------------------------------------


def _reduce_mixer(m, d_model: int):
    if isinstance(m, AttnSpec):
        return dataclasses.replace(m, window=min(m.window, 8) if m.window else 0)
    if isinstance(m, SSMSpec):
        return dataclasses.replace(m, d_inner=2 * d_model, head_dim=16, state_dim=16, chunk=8)
    if isinstance(m, LRUSpec):
        return dataclasses.replace(m, lru_width=d_model, num_heads=2)
    raise TypeError(m)


def _reduce_ffn(f: FFNSpec) -> FFNSpec:
    kw = dict(d_ff=64 if f.d_ff else 0)
    if f.kind == "moe":
        kw.update(num_experts=min(f.num_experts, 4), top_k=min(f.top_k, 2), capacity_factor=2.0)
        if f.residual:
            kw.update(residual_d_ff=64)
    return dataclasses.replace(f, **kw)


def with_capacity_factor(cfg: ModelConfig, cf: float) -> ModelConfig:
    """Rebuild a config with every MoE layer's capacity factor replaced —
    perf knob for the §Perf iterations (capacity padding scales every
    dispatch buffer, a2a and expert-slicing reduction linearly)."""
    def seg_map(segs):
        out = []
        for seg in segs:
            pat = tuple(
                LayerSpec(
                    ls.mixer,
                    dataclasses.replace(ls.ffn, capacity_factor=cf) if ls.ffn.kind == "moe" else ls.ffn,
                    cross=ls.cross,
                )
                for ls in seg.pattern
            )
            out.append(Segment(pat, seg.repeats))
        return tuple(out)

    enc = None
    if cfg.encoder is not None:
        enc = EncoderConfig(segments=seg_map(cfg.encoder.segments), max_source_len=cfg.encoder.max_source_len)
    return cfg.replace(segments=seg_map(cfg.segments), encoder=enc)


def with_moe_ffn(cfg: ModelConfig, **kw) -> ModelConfig:
    """Rebuild a config with every MoE layer's FFNSpec fields overridden
    (num_experts=8, capacity_factor=8.0, ...).  The EP serving tests use it
    to make reduced expert counts divisible by a device mesh and to give the
    a2a schedule drop-free capacity headroom."""
    def seg_map(segs):
        out = []
        for seg in segs:
            pat = tuple(
                LayerSpec(
                    ls.mixer,
                    dataclasses.replace(ls.ffn, **kw) if ls.ffn.kind == "moe" else ls.ffn,
                    cross=ls.cross,
                )
                for ls in seg.pattern
            )
            out.append(Segment(pat, seg.repeats))
        return tuple(out)

    enc = None
    if cfg.encoder is not None:
        enc = EncoderConfig(segments=seg_map(cfg.encoder.segments), max_source_len=cfg.encoder.max_source_len)
    return cfg.replace(segments=seg_map(cfg.segments), encoder=enc)


def make_reduced(cfg: ModelConfig, d_model: int = 128) -> ModelConfig:
    """Same family/pattern, tiny dims: one repeat of each segment pattern."""
    heads = 4
    segs = []
    for seg in cfg.segments:
        pat = tuple(
            LayerSpec(
                _reduce_mixer(ls.mixer, d_model),
                _reduce_ffn(ls.ffn),
                cross=ls.cross,
            )
            for ls in seg.pattern
        )
        segs.append(Segment(pat, 1))
    enc = None
    if cfg.encoder is not None:
        epat = []
        for seg in cfg.encoder.segments:
            epat.append(
                Segment(
                    tuple(
                        LayerSpec(_reduce_mixer(ls.mixer, d_model), _reduce_ffn(ls.ffn), cross=ls.cross)
                        for ls in seg.pattern
                    ),
                    1,
                )
            )
        enc = EncoderConfig(segments=tuple(epat), max_source_len=32)
    fe = None
    if cfg.frontend is not None:
        fe = FrontendSpec(kind=cfg.frontend.kind, n_tokens=8, embed_dim=32)
    return cfg.replace(
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=max(1, heads * cfg.num_kv_heads // max(cfg.num_heads, 1)),
        head_dim=32,
        vocab_size=512,
        segments=tuple(segs),
        encoder=enc,
        frontend=fe,
        max_seq_len=4096,
        param_dtype="float32",
        compute_dtype="float32",
        # moe_impl is preserved: without a mesh, "ep" falls back to dense
        # dispatch anyway, and under a mesh the shard_map EP path is the one
        # that partitions correctly (the GSPMD-partitioned dense scatter/
        # gather dispatch miscomputes under grad on older XLA SPMD — see
        # core/dispatch.py::combine_dense).
    )
