"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
RoPE + GQA.  [hf:THUDM/glm-4-9b]"""
from repro_torch.configs.base import AttnSpec, FFNSpec, LayerSpec, ModelConfig, uniform_segments

_LAYER = LayerSpec(
    AttnSpec(kind="global", rope_theta=10_000.0),
    FFNSpec(kind="dense", d_ff=13_696, act="swiglu"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        source="[hf:THUDM/glm-4-9b]",
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        vocab_size=151_552,
        segments=uniform_segments(_LAYER, 40),
        max_seq_len=131_072,
        supports_long_context=False,  # pure full attention -> long_500k skipped
    )
