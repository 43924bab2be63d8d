"""Paged chunk-prefill attention: the wrapper of the hand-written Hopper kernel
``csrc/paged_prefill_attention.cu`` and its plain PyTorch version.

The kernel replaces
``repro/kernels/attention_prefill_paged.py::paged_prefill_attention`` (the TPU
kernel), both its branches: a full-precision pool (kernel 8) and an int8 pool
with f32 scales per (key, kv-head) (``k_scale``/``v_scale`` given, kernel
8q).  Its design and bound are in the source's note and in
``csrc/paged_mma.cuh`` (bf16) and ``csrc/paged_attention.cuh`` (f32).  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or raises.  ``launches`` counts the wrapper's kernel launches per branch.

``paged_prefill_attention_batched`` is the same kernel over B rows at once
(one launch, a row index on the grid), for the engine's batched prefill
tick: each row has its own table row, chunk positions (-1 at padding, all -1
for an inactive row) and chunk K/V, and masks its pool history from its own
chunk start.  A padded query, and every query of an inactive row, gives
exactly 0.  It counts its launches under its own keys.

The caller hands it the PRE-write pool: the chunk's own K/V arrive as
``ck``/``cv``, in q's type also over an int8 pool, and are written (and
quantized) into their pages after this call.  The int8 pool is dequantized as
in ``attention_paged.py``: to q's type in the plain version, in f32 in the
kernel (in bf16 its scales go to the products, and the probabilities are
rounded to bf16 for P.V on the tensor cores).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention_paged import check_pool_args, kv_values, masked_softmax_pv
from repro_torch.kernels.no_backward import SERVING_KERNELS, refuse_grad

PREFILL_PV = "hgct,thd->chgd"

launches = {"paged_prefill_attention": 0, "paged_prefill_attention_int8": 0,
            "paged_prefill_attention_batched": 0, "paged_prefill_attention_batched_int8": 0}

_HEAD = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_float]
_C_ARGS = _HEAD + [ctypes.c_void_p]
_C_ARGS_INT8 = [ctypes.c_void_p] * 2 + _C_ARGS  # + the two scale pointers
# batched: + B and the row strides of q / out, ck / cv, table and qpos
_C_ARGS_BATCHED = _HEAD + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
_C_ARGS_BATCHED_INT8 = [ctypes.c_void_p] * 2 + _C_ARGS_BATCHED


def _library():
    lib = build.load_library("paged_prefill_attention")
    for fn, args in ((lib.paged_prefill_attention_bf16, _C_ARGS),
                     (lib.paged_prefill_attention_f32, _C_ARGS),
                     (lib.paged_prefill_attention_int8_bf16, _C_ARGS_INT8),
                     (lib.paged_prefill_attention_int8_f32, _C_ARGS_INT8),
                     (lib.paged_prefill_attention_batched_bf16, _C_ARGS_BATCHED),
                     (lib.paged_prefill_attention_batched_f32, _C_ARGS_BATCHED),
                     (lib.paged_prefill_attention_batched_int8_bf16, _C_ARGS_BATCHED_INT8),
                     (lib.paged_prefill_attention_batched_int8_f32, _C_ARGS_BATCHED_INT8)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def prefill_scores(q, k_pool, v_pool, kpos, table, qpos, ck, cv, k_scale=None, v_scale=None):
    """The plain version's gather: the table's pages as a contiguous history
    (dequantized, for an int8 pool; keys at positions >= the chunk start
    masked) with the chunk's K/V appended, T keys in all, and (f32 q.k
    scores [Hkv, G, C, T], key positions [1, 1, 1, T], query positions
    [1, 1, C, 1], f32 values [T, Hkv, dh])."""
    C, Hkv, G, dh = q.shape
    ps = k_pool.shape[1]
    idx = table.long()
    n = idx.shape[0] * ps
    gather = lambda pool, w: None if pool is None else pool[idx].reshape(n, Hkv, w)
    k = torch.cat([kv_values(gather(k_pool, dh), gather(k_scale, 1), q.dtype), ck.float()])
    v = torch.cat([kv_values(gather(v_pool, dh), gather(v_scale, 1), q.dtype), cv.float()])
    hist = kpos[idx].reshape(n)
    hist = torch.where(hist >= qpos[0], -1, hist)  # the pool is strictly pre-chunk
    kp = torch.cat([hist, qpos])[None, None, None, :]  # [1, 1, 1, T]
    qp = qpos.reshape(1, 1, C, 1)
    return torch.einsum("chgd,thd->hgct", q.float(), k), kp, qp, v


def paged_prefill_attention_plain(q, k_pool, v_pool, kpos, table, qpos, ck, cv, *, scale: float,
                                  causal: bool = True, window: int = 0, softcap: float = 0.0,
                                  k_scale=None, v_scale=None):
    """The kernel's function in PyTorch, as ``paged_prefill_attention_ref``
    computes it: ``prefill_scores``, then a masked f32 softmax over the
    union of history and chunk."""
    s, kp, qp, v = prefill_scores(q, k_pool, v_pool, kpos, table, qpos, ck, cv, k_scale, v_scale)
    out = masked_softmax_pv(s, kp, qp, v, PREFILL_PV, scale=scale, causal=causal, window=window,
                            softcap=softcap)
    return out.to(q.dtype)


def paged_prefill_attention(
    q: torch.Tensor,  # [C, Hkv, G, dh] — one chunk of prompt queries
    k_pool: torch.Tensor,  # [Pt, ps, Hkv, dh] page pool, before the chunk's write
    v_pool: torch.Tensor,  # [Pt, ps, Hkv, dh]
    kpos: torch.Tensor,  # [Pt, ps] int32 — absolute position per entry, -1 empty
    table: torch.Tensor,  # [nt] int32 — the sequence's page ids, pre-clamped
    qpos: torch.Tensor,  # [C] int32 — the chunk tokens' absolute positions
    ck: torch.Tensor,  # [C, Hkv, dh] — the chunk's in-flight keys
    cv: torch.Tensor,  # [C, Hkv, dh] — the chunk's in-flight values
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # [Pt, ps, Hkv, 1] f32: the pool is int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[C, Hkv, G, dh] attention output in q's type.  With ``k_scale`` /
    ``v_scale`` the pool holds int8 values (kernel 8q)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, kpos, table, qpos, ck, cv,
                                             scale=scale, causal=causal, window=window,
                                             softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for device {q.device}")
    refuse_grad("paged_prefill_attention", SERVING_KERNELS, q, k_pool, v_pool, ck, cv, k_scale,
                v_scale)
    check_pool_args("paged_prefill_attention", q, k_pool, v_pool, kpos, table, qpos,
                    extra=(("ck", ck), ("cv", cv)), k_scale=k_scale, v_scale=v_scale)
    C, Hkv, G, dh = q.shape
    Pt, ps = kpos.shape
    if table.ndim != 1 or qpos.shape != (C,) or ck.shape != (C, Hkv, dh) or cv.shape != ck.shape:
        raise ValueError(f"paged_prefill_attention: table {tuple(table.shape)}, qpos "
                         f"{tuple(qpos.shape)}, ck {tuple(ck.shape)}, cv {tuple(cv.shape)} "
                         f"do not match q {tuple(q.shape)}")
    lib = _library()
    bf16 = q.dtype == torch.bfloat16
    if k_scale is None:
        key = "paged_prefill_attention"
        fn = lib.paged_prefill_attention_bf16 if bf16 else lib.paged_prefill_attention_f32
        kv = (k_pool.data_ptr(), v_pool.data_ptr())
    else:
        key = "paged_prefill_attention_int8"
        fn = lib.paged_prefill_attention_int8_bf16 if bf16 else lib.paged_prefill_attention_int8_f32
        kv = (k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(), v_scale.data_ptr())
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *kv, kpos.data_ptr(), table.data_ptr(), qpos.data_ptr(),
                 ck.data_ptr(), cv.data_ptr(), out.data_ptr(), C, Hkv, G, dh, ps, table.shape[0],
                 Pt, float(scale), int(causal), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention: kernel launch failed with CUDA error {err}")
    launches[key] += 1
    return out


BATCHED_PV = "bhgct,bthd->bchgd"


def paged_prefill_attention_batched_plain(q, k_pool, v_pool, kpos, tables, qpos, ck, cv, *,
                                          scale: float, causal: bool = True, window: int = 0,
                                          softcap: float = 0.0, k_scale=None, v_scale=None):
    """The batched kernel's function in PyTorch: per row, the table row's
    pages as a contiguous history (keys at positions >= the row's own chunk
    start ``qpos[b, 0]`` masked) with the row's chunk K/V appended, and a
    masked f32 softmax over the union; padded queries (position < 0) give 0,
    as in ``_paged_prefill_chunk_attend_batched``'s kernel path."""
    B, C, Hkv, G, dh = q.shape
    ps = k_pool.shape[1]
    idx = tables.long()
    n = idx.shape[1] * ps
    gather = lambda pool, w: None if pool is None else pool[idx].reshape(B, n, Hkv, w)
    k = torch.cat([kv_values(gather(k_pool, dh), gather(k_scale, 1), q.dtype), ck.float()], 1)
    v = torch.cat([kv_values(gather(v_pool, dh), gather(v_scale, 1), q.dtype), cv.float()], 1)
    hist = kpos[idx].reshape(B, n)
    hist = torch.where(hist >= qpos[:, :1], -1, hist)  # each row's pool is strictly pre-chunk
    kp = torch.cat([hist, qpos], 1)[:, None, None, None, :]  # [B, 1, 1, 1, T]
    qp = qpos.reshape(B, 1, 1, C, 1)
    s = torch.einsum("bchgd,bthd->bhgct", q.float(), k)
    out = masked_softmax_pv(s, kp, qp, v, BATCHED_PV, scale=scale, causal=causal, window=window,
                            softcap=softcap)
    return torch.where(qpos[:, :, None, None, None] >= 0, out, 0.0).to(q.dtype)


def paged_prefill_attention_batched(
    q: torch.Tensor,  # [B, C, Hkv, G, dh] — one chunk of prompt queries per row
    k_pool: torch.Tensor,  # [Pt, ps, Hkv, dh] page pool, before the chunks' writes
    v_pool: torch.Tensor,  # [Pt, ps, Hkv, dh]
    kpos: torch.Tensor,  # [Pt, ps] int32 — absolute position per entry, -1 empty
    tables: torch.Tensor,  # [B, nt] int32 — each row's page ids, pre-clamped
    qpos: torch.Tensor,  # [B, C] int32 — absolute positions, -1 at padding
    ck: torch.Tensor,  # [B, C, Hkv, dh] — the chunks' in-flight keys
    cv: torch.Tensor,  # [B, C, Hkv, dh] — the chunks' in-flight values
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # [Pt, ps, Hkv, 1] f32: the pool is int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, C, Hkv, G, dh] attention output in q's type, every row in one
    launch.  With ``k_scale`` / ``v_scale`` the pool holds int8 values
    (kernel 8q)."""
    if q.device.type == "cpu":
        return paged_prefill_attention_batched_plain(
            q, k_pool, v_pool, kpos, tables, qpos, ck, cv, scale=scale, causal=causal,
            window=window, softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention_batched: no kernel for device {q.device}")
    refuse_grad("paged_prefill_attention_batched", SERVING_KERNELS, q, k_pool, v_pool, ck, cv,
                k_scale, v_scale)
    name = "paged_prefill_attention_batched"
    B, C, Hkv, G, dh = q.shape
    if (tables.ndim != 2 or tables.shape[0] != B or qpos.shape != (B, C)
            or ck.shape != (B, C, Hkv, dh) or cv.shape != ck.shape):
        raise ValueError(f"{name}: tables {tuple(tables.shape)}, qpos {tuple(qpos.shape)}, ck "
                         f"{tuple(ck.shape)}, cv {tuple(cv.shape)} do not match q {tuple(q.shape)}")
    check_pool_args(name, q.view(B * C, Hkv, G, dh), k_pool, v_pool, kpos, tables, qpos,
                    extra=(("ck", ck), ("cv", cv)), k_scale=k_scale, v_scale=v_scale)
    Pt, ps = kpos.shape
    lib = _library()
    bf16 = q.dtype == torch.bfloat16
    if k_scale is None:
        key = name
        fn = lib.paged_prefill_attention_batched_bf16 if bf16 else lib.paged_prefill_attention_batched_f32
        kv = (k_pool.data_ptr(), v_pool.data_ptr())
    else:
        key = f"{name}_int8"
        fn = (lib.paged_prefill_attention_batched_int8_bf16 if bf16
              else lib.paged_prefill_attention_batched_int8_f32)
        kv = (k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(), v_scale.data_ptr())
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *kv, kpos.data_ptr(), tables.data_ptr(), qpos.data_ptr(),
                 ck.data_ptr(), cv.data_ptr(), out.data_ptr(), C, Hkv, G, dh, ps, tables.shape[1],
                 Pt, float(scale), int(causal), int(window), float(softcap), B, q.stride(0),
                 ck.stride(0), tables.stride(0), qpos.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[key] += 1
    return out
