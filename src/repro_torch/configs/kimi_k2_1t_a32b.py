"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per
expert) vocab=163840, MoE 384 experts top-8 + 1 shared expert; first layer
dense (DeepSeek-V3-style).  Trillion-parameter MoE — the paper-table scale
case (DS-MoE Table 6 / Fig. 11 trillion-parameter regime).
[arXiv:2501.kimi2]"""
from repro_torch.configs.base import AttnSpec, FFNSpec, LayerSpec, ModelConfig, Segment

_ATTN = AttnSpec(kind="global", rope_theta=50_000.0)
_DENSE = LayerSpec(_ATTN, FFNSpec(kind="dense", d_ff=18_432, act="swiglu"))
_MOE = LayerSpec(
    _ATTN,
    FFNSpec(
        kind="moe",
        d_ff=2048,
        act="swiglu",
        num_experts=384,
        top_k=8,
        capacity_factor=1.25,
        residual=True,  # shared expert
        residual_d_ff=2048,
    ),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        source="[arXiv:2501.kimi2]",
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=112,
        vocab_size=163_840,
        segments=(Segment((_DENSE,), 1), Segment((_MOE,), 60)),
        max_seq_len=131_072,
        supports_long_context=False,
        moe_impl="ep",
    )
