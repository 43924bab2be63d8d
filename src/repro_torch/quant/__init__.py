"""MoQ weight-only quantization (DeepSpeed-MoE §4) and the int8 KV cache
(§5) of the port (``repro/quant``): int8 / int4 expert weights dequantized
inside the grouped expert kernel, and K/V quantized on write and dequantized
inside the decode and prefill attention kernels."""
from repro_torch.quant.kv import QuantizedKV, kv_cache_bytes, kv_quantize_values, materialize_kv
from repro_torch.quant.ptq import (
    dequantize_params,
    prepare_params_for_serving,
    quantize_params,
    quantized_leaf_paths,
    tree_bytes,
)
from repro_torch.quant.qarrays import QuantizedArray, materialize

__all__ = [
    "QuantizedArray",
    "QuantizedKV",
    "materialize",
    "materialize_kv",
    "kv_quantize_values",
    "kv_cache_bytes",
    "quantize_params",
    "dequantize_params",
    "prepare_params_for_serving",
    "quantized_leaf_paths",
    "tree_bytes",
]
