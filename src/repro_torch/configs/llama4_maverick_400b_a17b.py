"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (per expert) vocab=202048, MoE 128 experts top-1 + shared expert
('early fusion' multimodal card; text backbone per assignment carve-out).
[hf:meta-llama/Llama-4-Scout-17B-16E family]

The shared-expert + top-1-routed design is exactly DeepSpeed-MoE's
Residual-MoE (paper §4.1.1): a fixed dense branch plus one routed expert.
MoE on alternating layers (interleave step 2), dense d_ff = 2x expert d_ff.
"""
from repro_torch.configs.base import AttnSpec, FFNSpec, LayerSpec, ModelConfig, patterned_segments

_ATTN = AttnSpec(kind="global", rope_theta=500_000.0)
_DENSE = LayerSpec(_ATTN, FFNSpec(kind="dense", d_ff=16_384, act="swiglu"))
_MOE = LayerSpec(
    _ATTN,
    FFNSpec(
        kind="moe",
        d_ff=8192,
        act="swiglu",
        num_experts=128,
        top_k=1,
        capacity_factor=1.25,
        residual=True,  # shared expert == Residual-MoE
        residual_d_ff=8192,
    ),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        source="[hf:meta-llama/Llama-4-Scout-17B-16E]",
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        vocab_size=202_048,
        segments=patterned_segments((_DENSE, _MOE), 48),
        max_seq_len=131_072,
        supports_long_context=False,  # treated as full attention here
        moe_impl="ep",
    )
