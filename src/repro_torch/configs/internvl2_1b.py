"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655; InternViT vision encoder STUBBED per assignment carve-out:
``input_specs`` supplies precomputed patch embeddings [B, 256, 1024] that a
learned projector maps to d_model and prepends to the token sequence.
[arXiv:2404.16821]"""
from repro_torch.configs.base import AttnSpec, FFNSpec, FrontendSpec, LayerSpec, ModelConfig, uniform_segments

_LAYER = LayerSpec(
    AttnSpec(kind="global", rope_theta=1_000_000.0),
    FFNSpec(kind="dense", d_ff=4864, act="swiglu"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        source="[arXiv:2404.16821]",
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        vocab_size=151_655,
        segments=uniform_segments(_LAYER, 24),
        frontend=FrontendSpec(kind="vision", n_tokens=256, embed_dim=1024),
        tie_embeddings=True,
        max_seq_len=32_768,
        supports_long_context=False,
    )
