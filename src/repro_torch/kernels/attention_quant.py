"""Decode attention over a contiguous int8 KV cache: the wrapper of the
hand-written Hopper kernel ``csrc/decode_attention_quant.cu`` and its plain
PyTorch version.

The kernel replaces ``repro/kernels/attention_quant.py::decode_attention_quant``
(the TPU kernel, kernel 9); its design and bound are in the source's note.  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or raises.  ``launches`` counts the wrapper's kernel launches.

Both versions zero masked probabilities, as kernels 7 and 8 do, so a row with
no valid key gives 0.  The JAX package's kernel and its
``decode_attention_quant_ref`` give such a row a uniform average instead;
rows with a valid key agree, and a static decode token always sees itself.
The plain version dequantizes K/V to q's type, as the JAX reference path does
(``materialize_kv``); the kernel dequantizes in f32, as the TPU kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention_paged import MAX_G, check_kv_args, kv_values, masked_softmax_pv

launches = {"decode_attention_quant": 0}

_C_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _library():
    lib = build.load_library("decode_attention_quant")
    for fn in (lib.decode_attention_quant_bf16, lib.decode_attention_quant_f32):
        fn.argtypes = _C_ARGS
        fn.restype = ctypes.c_int
    return lib


def decode_attention_quant_plain(q, kq, ks, vq, vs, kpos, qpos, *, scale: float,
                                 causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The kernel's function in PyTorch, as ``decode_attention_quant_ref``
    computes it (with masked entries zeroed): dequantize the cache, masked
    f32 softmax."""
    B, Hkv, G, dh = q.shape
    T = kq.shape[1]
    k = kv_values(kq, ks, q.dtype)
    v = kv_values(vq, vs, q.dtype)
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k)
    out = masked_softmax_pv(s, kpos.reshape(B, 1, 1, T), qpos.reshape(B, 1, 1, 1), v,
                            "bhgt,bthd->bhgd", scale=scale, causal=causal, window=window,
                            softcap=softcap)
    return out.to(q.dtype)


def decode_attention_quant(
    q: torch.Tensor,  # [B, Hkv, G, dh] — one decode token per row, grouped per kv-head
    kq: torch.Tensor,  # [B, T, Hkv, dh] int8
    ks: torch.Tensor,  # [B, T, Hkv, 1] f32
    vq: torch.Tensor,  # [B, T, Hkv, dh] int8
    vs: torch.Tensor,  # [B, T, Hkv, 1] f32
    kpos: torch.Tensor,  # [B, T] int32 — absolute position per slot, -1 empty
    qpos: torch.Tensor,  # [B] int32 — the query token's absolute position
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """[B, Hkv, G, dh] attention output in q's type."""
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, kq, ks, vq, vs, kpos, qpos, scale=scale,
                                            causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant: no kernel for device {q.device}")
    name = "decode_attention_quant"
    check_kv_args(name, q, kq, vq, ks, vs)
    B, Hkv, G, dh = q.shape
    T = kq.shape[1]
    for n, t in (("q", q), ("kpos", kpos), ("qpos", qpos)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous on {q.device}")
    if kpos.dtype != torch.int32 or qpos.dtype != torch.int32:
        raise TypeError(f"{name}: kpos and qpos must be int32")
    if kq.shape != (B, T, Hkv, dh) or kpos.shape != (B, T) or qpos.numel() != B:
        raise ValueError(f"{name}: cache {tuple(kq.shape)}, kpos {tuple(kpos.shape)}, qpos "
                         f"{tuple(qpos.shape)} do not match q {tuple(q.shape)}")
    if G > MAX_G:
        raise ValueError(f"{name}: {G} query heads per kv-head exceed {MAX_G}")
    lib = _library()
    fn = lib.decode_attention_quant_bf16 if q.dtype == torch.bfloat16 else lib.decode_attention_quant_f32
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                 kpos.data_ptr(), qpos.data_ptr(), out.data_ptr(), B, Hkv, G, dh, T, float(scale),
                 int(causal), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1
    return out
