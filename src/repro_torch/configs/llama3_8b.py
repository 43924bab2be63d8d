"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  [arXiv:2407.21783]"""
from repro_torch.configs.base import AttnSpec, FFNSpec, LayerSpec, ModelConfig, uniform_segments

_LAYER = LayerSpec(
    AttnSpec(kind="global", rope_theta=500_000.0),
    FFNSpec(kind="dense", d_ff=14_336, act="swiglu"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        source="[arXiv:2407.21783]",
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        vocab_size=128_256,
        segments=uniform_segments(_LAYER, 32),
        max_seq_len=131_072,
        supports_long_context=False,
    )
