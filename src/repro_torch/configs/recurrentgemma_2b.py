"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1, MQA)
d_ff=7680 vocab=256000, RG-LRU + local attention, pattern 2 recurrent : 1
local-attn.  [arXiv:2402.19427]"""
from repro_torch.configs.base import AttnSpec, FFNSpec, LayerSpec, LRUSpec, ModelConfig, patterned_segments

_FFN = FFNSpec(kind="dense", d_ff=7680, act="swiglu")
_REC = LayerSpec(LRUSpec(lru_width=2560, conv_dim=4, num_heads=10), _FFN)
_LOC = LayerSpec(AttnSpec(kind="local", window=2048, rope_theta=10_000.0), _FFN)

# Griffin block pattern: (recurrent, recurrent, local attention)
_PATTERN = (_REC, _REC, _LOC)


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        source="[arXiv:2402.19427]",
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        vocab_size=256_000,
        segments=patterned_segments(_PATTERN, 26),
        tie_embeddings=True,
        max_seq_len=1_048_576,
        supports_long_context=True,  # LRU state + bounded window cache
    )
