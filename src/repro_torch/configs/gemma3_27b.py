"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt family card, scaled per assignment]"""
from repro_torch.configs.base import AttnSpec, FFNSpec, LayerSpec, ModelConfig, patterned_segments

_LOCAL = AttnSpec(kind="local", window=1024, rope_theta=10_000.0, qk_norm=True)
_GLOBAL = AttnSpec(kind="global", rope_theta=1_000_000.0, qk_norm=True)
_FFN = FFNSpec(kind="dense", d_ff=21_504, act="swiglu")

# 5 local : 1 global, tiled over 62 layers (10 full periods + 2 local tail)
_PATTERN = tuple(LayerSpec(m, _FFN) for m in (_LOCAL,) * 5 + (_GLOBAL,))


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        source="[hf:google/gemma-3-1b-pt]",
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        vocab_size=262_144,
        segments=patterned_segments(_PATTERN, 62),
        tie_embeddings=True,
        max_seq_len=131_072,
        # local layers have a 1024 ring cache; the single global-layer class
        # decodes linearly in S -> long_500k is runnable (DESIGN.md §5).
        supports_long_context=True,
    )
