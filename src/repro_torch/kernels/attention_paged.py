"""Paged decode attention: the wrapper of the hand-written Hopper kernel
``csrc/paged_decode_attention.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/attention_paged.py::paged_decode_attention``
(the TPU kernel), both its branches: a full-precision pool (kernel 7) and an
int8 pool with f32 scales per (key, kv-head) (``k_scale``/``v_scale`` given,
kernel 7q).  Its design and bound are in the source's note and in
``csrc/paged_attention.cuh``.  A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises.  ``launches`` counts the wrapper's
kernel launches per branch, so a run can show that its main path went
through the kernel.

Over an int8 pool the plain version dequantizes to the query's type, as the
JAX reference path does (``materialize_kv``); the kernel dequantizes in f32,
as the TPU kernel does.  In f32 the two are the same; in bf16 they differ by
one bf16 rounding of each K/V value.

Both versions compute one function: masked entries get probability 0, so a
row with no valid key (an inactive slot, whose table row is all trash) gives
0, finite.  The JAX package's ``paged_decode_attention_ref`` gives such a row
a uniform average instead; rows with a valid key agree.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant.kv import QuantizedKV

NEG_INF = -1e30
KEYS_PER_TILE = 32  # paged_attention.cuh KT: a page must fit in one tile
HEAD_DIMS = (32, 64, 128)  # head dims the kernels are instantiated for
MAX_G = 16  # query heads per kv-head in one decode block

launches = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0}

_C_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_C_ARGS_INT8 = [ctypes.c_void_p] * 2 + _C_ARGS  # + the two scale pointers


def _library():
    lib = build.load_library("paged_decode_attention")
    for fn, args in ((lib.paged_decode_attention_bf16, _C_ARGS),
                     (lib.paged_decode_attention_f32, _C_ARGS),
                     (lib.paged_decode_attention_int8_bf16, _C_ARGS_INT8),
                     (lib.paged_decode_attention_int8_f32, _C_ARGS_INT8)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def kv_values(x, scale, dtype):
    """Gathered cache values as f32: fp values widened, or int8 values
    dequantized to ``dtype`` (``materialize_kv``), then widened."""
    if scale is None:
        return x.float()
    return QuantizedKV(x, scale, dtype).dequantize().float()


def masked_softmax_pv(s, kp, qp, v, pv: str, *, scale, causal, window, softcap):
    """The kernels' arithmetic in plain PyTorch: scores ``s`` (f32 q.k) scaled
    and softcapped, masked by key positions ``kp`` against query positions
    ``qp`` (validity kp >= 0, causal, window), softmax with masked entries
    zeroed, then ``einsum(pv, p, v)`` in f32."""
    s = s * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window > 0:
        valid = valid & (qp - kp < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum(pv, p, v)


def paged_decode_attention_plain(q, k_pool, v_pool, kpos, table, qpos, *, scale: float,
                                 causal: bool = True, window: int = 0, softcap: float = 0.0,
                                 k_scale=None, v_scale=None):
    """The kernel's function in PyTorch, as ``paged_decode_attention_ref``
    computes it: gather the table's pages into a contiguous ``[B, nt*ps]``
    history (dequantized, for an int8 pool) and run a masked f32 softmax over
    it."""
    B, Hkv, G, dh = q.shape
    ps = k_pool.shape[1]
    idx = table.long()
    nt = idx.shape[1]
    gather = lambda pool, n: None if pool is None else pool[idx].reshape(B, nt * ps, Hkv, n)
    k = kv_values(gather(k_pool, dh), gather(k_scale, 1), q.dtype)
    v = kv_values(gather(v_pool, dh), gather(v_scale, 1), q.dtype)
    kp = kpos[idx].reshape(B, 1, 1, nt * ps)
    qp = qpos.reshape(B, 1, 1, 1)
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k)
    out = masked_softmax_pv(s, kp, qp, v, "bhgt,bthd->bhgd", scale=scale, causal=causal,
                            window=window, softcap=softcap)
    return out.to(q.dtype)


def check_kv_args(name, q, k, v, k_scale, v_scale, extra=()):
    """Checks of the K/V a kernel reads: the cache ``k``/``v`` in q's type,
    or int8 with f32 scales ``[..., 1]`` matching them; ``extra`` are
    further (name, tensor) pairs in q's type (the chunk's K/V)."""
    dev = q.device
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {q.dtype} not supported (bfloat16, float32)")
    named = [("k", k), ("v", v), *extra] + ([("k_scale", k_scale), ("v_scale", v_scale)] if quant else [])
    for n, t in named:
        if t.device != dev:
            raise ValueError(f"{name}: {n} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    want = {"k": torch.int8 if quant else q.dtype, "v": torch.int8 if quant else q.dtype}
    for n, t in [("k", k), ("v", v), *extra]:
        if t.dtype != want.get(n, q.dtype):
            raise TypeError(f"{name}: {n} is {t.dtype}, expected {want.get(n, q.dtype)}")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name}: {n} must be aligned to 4 elements")
    if quant:
        for n, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or t.shape != k.shape[:-1] + (1,):
                raise ValueError(f"{name}: {n} must be float32 of shape {tuple(k.shape[:-1]) + (1,)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {k.shape[-1]} not supported (kernels built for {HEAD_DIMS})")


def check_pool_args(name, q, k_pool, v_pool, kpos, table, qpos, extra=(), k_scale=None,
                    v_scale=None):
    """The layout checks both paged kernels share; ``extra`` are further
    (name, tensor) pairs in the input type (the chunk's K/V)."""
    check_kv_args(name, q, k_pool, v_pool, k_scale, v_scale, extra)
    dev = q.device
    for n, t in (("q", q), ("kpos", kpos), ("table", table), ("qpos", qpos)):
        if t.device != dev:
            raise ValueError(f"{name}: {n} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    for n, t in (("kpos", kpos), ("table", table), ("qpos", qpos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {n} must be int32, got {t.dtype}")
    Pt, ps, Hkv, dh = k_pool.shape
    if kpos.shape != (Pt, ps):
        raise ValueError(f"{name}: pool shapes k {tuple(k_pool.shape)} pos {tuple(kpos.shape)} "
                         "do not match")
    if q.shape[1] != Hkv or q.shape[3] != dh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the pool's Hkv={Hkv}, dh={dh}")
    if ps > KEYS_PER_TILE:
        raise ValueError(f"{name}: page_size {ps} exceeds {KEYS_PER_TILE} keys per tile")


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hkv, G, dh] — one decode token per slot, grouped per kv-head
    k_pool: torch.Tensor,  # [Pt, ps, Hkv, dh] page pool (last page = trash)
    v_pool: torch.Tensor,  # [Pt, ps, Hkv, dh]
    kpos: torch.Tensor,  # [Pt, ps] int32 — absolute position per entry, -1 empty
    table: torch.Tensor,  # [B, nt] int32 — page ids, pre-clamped: -1 -> Pt - 1
    qpos: torch.Tensor,  # [B] int32 — the query token's absolute position
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # [Pt, ps, Hkv, 1] f32: the pool is int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, Hkv, G, dh] attention output in q's type.  Caller contract as the
    TPU kernel's: the table is pre-clamped, and ``kpos`` is -1 for every
    entry not holding a valid token (trash page, fresh and recycled pages).
    With ``k_scale``/``v_scale`` the pool holds int8 values (kernel 7q)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, kpos, table, qpos, scale=scale,
                                            causal=causal, window=window, softcap=softcap,
                                            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    check_pool_args("paged_decode_attention", q, k_pool, v_pool, kpos, table, qpos,
                    k_scale=k_scale, v_scale=v_scale)
    B, Hkv, G, dh = q.shape
    Pt, ps = kpos.shape
    nt = table.shape[-1]
    if table.shape != (B, nt) or qpos.numel() != B:
        raise ValueError(f"paged_decode_attention: table {tuple(table.shape)} / qpos "
                         f"{tuple(qpos.shape)} do not match B={B}")
    if G > MAX_G:
        raise ValueError(f"paged_decode_attention: {G} query heads per kv-head exceed {MAX_G}")
    lib = _library()
    bf16 = q.dtype == torch.bfloat16
    if k_scale is None:
        key = "paged_decode_attention"
        fn = lib.paged_decode_attention_bf16 if bf16 else lib.paged_decode_attention_f32
        kv = (k_pool.data_ptr(), v_pool.data_ptr())
    else:
        key = "paged_decode_attention_int8"
        fn = lib.paged_decode_attention_int8_bf16 if bf16 else lib.paged_decode_attention_int8_f32
        kv = (k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(), v_scale.data_ptr())
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *kv, kpos.data_ptr(), table.data_ptr(), qpos.data_ptr(),
                 out.data_ptr(), B, Hkv, G, dh, ps, nt, Pt, float(scale), int(causal), int(window),
                 float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed with CUDA error {err}")
    launches[key] += 1
    return out
