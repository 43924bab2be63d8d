"""Paged decode attention: the wrapper of the hand-written Hopper kernel
``csrc/paged_decode_attention.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/attention_paged.py::paged_decode_attention``
(the TPU kernel, full-precision pool); its design and bound are in the
source's note and in ``csrc/paged_attention.cuh``.  A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel or raises.  ``launches``
counts the wrapper's kernel launches, so a run can show that its main path
went through the kernel.

Both versions compute one function: masked entries get probability 0, so a
row with no valid key (an inactive slot, whose table row is all trash) gives
0, finite.  The JAX package's ``paged_decode_attention_ref`` gives such a row
a uniform average instead; rows with a valid key agree.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
KEYS_PER_TILE = 32  # paged_attention.cuh KT: a page must fit in one tile
HEAD_DIMS = (32, 64, 128)  # head dims the kernels are instantiated for
MAX_G = 16  # query heads per kv-head in one decode block

launches = {"paged_decode_attention": 0}

_C_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _library():
    lib = build.load_library("paged_decode_attention")
    for fn in (lib.paged_decode_attention_bf16, lib.paged_decode_attention_f32):
        fn.argtypes = _C_ARGS
        fn.restype = ctypes.c_int
    return lib


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
                                 causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The kernel's function in PyTorch, as ``paged_decode_attention_ref``
    computes it: gather the table's pages into a contiguous ``[B, nt*ps]``
    history and run a masked f32 softmax over it."""
    B, Hkv, G, dh = q.shape
    ps = k_pool.shape[1]
    idx = table.long()
    nt = idx.shape[1]
    k = k_pool[idx].reshape(B, nt * ps, Hkv, dh).float()
    v = v_pool[idx].reshape(B, nt * ps, Hkv, dh).float()
    kp = kpos[idx].reshape(B, 1, 1, nt * ps)
    qp = qpos.reshape(B, 1, 1, 1)
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k)
    out = masked_softmax_pv(s, kp, qp, v, "bhgt,bthd->bhgd", scale=scale, causal=causal,
                            window=window, softcap=softcap)
    return out.to(q.dtype)


def check_pool_args(name, q, k_pool, v_pool, kpos, table, qpos, extra=()):
    """The layout checks both paged kernels share; ``extra`` are further
    (name, tensor) pairs in the input type (the chunk's K/V)."""
    dev = q.device
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("kpos", kpos),
             ("table", table), ("qpos", qpos), *extra]
    for n, t in named:
        if t.device != dev:
            raise ValueError(f"{name}: {n} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {q.dtype} not supported (bfloat16, float32)")
    for n, t in [("k_pool", k_pool), ("v_pool", v_pool), *extra]:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {n} is {t.dtype}, q is {q.dtype}")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name}: {n} must be aligned to 4 elements")
    for n, t in (("kpos", kpos), ("table", table), ("qpos", qpos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {n} must be int32, got {t.dtype}")
    Pt, ps, Hkv, dh = k_pool.shape
    if v_pool.shape != k_pool.shape or kpos.shape != (Pt, ps):
        raise ValueError(f"{name}: pool shapes k {tuple(k_pool.shape)} v {tuple(v_pool.shape)} "
                         f"pos {tuple(kpos.shape)} do not match")
    if q.shape[1] != Hkv or q.shape[3] != dh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match the pool's Hkv={Hkv}, dh={dh}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not supported (kernels built for {HEAD_DIMS})")
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
) -> torch.Tensor:
    """[B, Hkv, G, dh] attention output in q's type.  Caller contract as the
    TPU kernel's: the table is pre-clamped, and ``kpos`` is -1 for every
    entry not holding a valid token (trash page, fresh and recycled pages)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, kpos, table, qpos, scale=scale,
                                            causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    check_pool_args("paged_decode_attention", q, k_pool, v_pool, kpos, table, qpos)
    B, Hkv, G, dh = q.shape
    Pt, ps = kpos.shape
    nt = table.shape[-1]
    if table.shape != (B, nt) or qpos.numel() != B:
        raise ValueError(f"paged_decode_attention: table {tuple(table.shape)} / qpos "
                         f"{tuple(qpos.shape)} do not match B={B}")
    if G > MAX_G:
        raise ValueError(f"paged_decode_attention: {G} query heads per kv-head exceed {MAX_G}")
    lib = _library()
    fn = lib.paged_decode_attention_bf16 if q.dtype == torch.bfloat16 else lib.paged_decode_attention_f32
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), kpos.data_ptr(),
                 table.data_ptr(), qpos.data_ptr(), out.data_ptr(), B, Hkv, G, dh, ps, nt, Pt,
                 float(scale), int(causal), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed with CUDA error {err}")
    launches["paged_decode_attention"] += 1
    return out
