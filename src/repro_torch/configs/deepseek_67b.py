"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-architecture.  [arXiv:2401.02954]"""
from repro_torch.configs.base import AttnSpec, FFNSpec, LayerSpec, ModelConfig, uniform_segments

_LAYER = LayerSpec(
    AttnSpec(kind="global", rope_theta=10_000.0),
    FFNSpec(kind="dense", d_ff=22_016, act="swiglu"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        source="[arXiv:2401.02954]",
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        vocab_size=102_400,
        segments=uniform_segments(_LAYER, 95),
        max_seq_len=131_072,
        supports_long_context=False,
    )
