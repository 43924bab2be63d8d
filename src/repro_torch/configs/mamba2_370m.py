"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, ssm_state=128,
vocab=50280.  SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.configs.base import FFNSpec, LayerSpec, ModelConfig, SSMSpec, uniform_segments

_LAYER = LayerSpec(
    SSMSpec(d_inner=2048, head_dim=64, state_dim=128, conv_dim=4, chunk=256, n_groups=1),
    FFNSpec(kind="none"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        source="[arXiv:2405.21060]",
        d_model=1024,
        num_heads=32,  # SSD heads (d_inner/head_dim); attention unused
        num_kv_heads=32,
        head_dim=64,
        vocab_size=50_280,
        segments=uniform_segments(_LAYER, 48),
        tie_embeddings=True,
        max_seq_len=1_048_576,
        supports_long_context=True,  # O(1) state decode
    )
