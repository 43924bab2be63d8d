"""Paged chunk-prefill attention: the wrapper of the hand-written Hopper kernel
``csrc/paged_prefill_attention.cu`` and its plain PyTorch version.

The kernel replaces
``repro/kernels/attention_prefill_paged.py::paged_prefill_attention`` (the TPU
kernel, full-precision pool); its design and bound are in the source's note
and in ``csrc/paged_attention.cuh``.  A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises.  ``launches`` counts
the wrapper's kernel launches.

The caller hands it the PRE-write pool: the chunk's own K/V arrive as
``ck``/``cv`` and are written into their pages after this call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention_paged import check_pool_args, masked_softmax_pv

launches = {"paged_prefill_attention": 0}

_C_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _library():
    lib = build.load_library("paged_prefill_attention")
    for fn in (lib.paged_prefill_attention_bf16, lib.paged_prefill_attention_f32):
        fn.argtypes = _C_ARGS
        fn.restype = ctypes.c_int
    return lib


def paged_prefill_attention_plain(q, k_pool, v_pool, kpos, table, qpos, ck, cv, *, scale: float,
                                  causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The kernel's function in PyTorch, as ``paged_prefill_attention_ref``
    computes it: the table's pages gathered into a contiguous history (keys
    at positions >= the chunk start masked), the chunk's K/V appended, a
    masked f32 softmax over the union."""
    C, Hkv, G, dh = q.shape
    ps = k_pool.shape[1]
    idx = table.long()
    n = idx.shape[0] * ps
    k = torch.cat([k_pool[idx].reshape(n, Hkv, dh), ck]).float()
    v = torch.cat([v_pool[idx].reshape(n, Hkv, dh), cv]).float()
    hist = kpos[idx].reshape(n)
    hist = torch.where(hist >= qpos[0], -1, hist)  # the pool is strictly pre-chunk
    kp = torch.cat([hist, qpos])[None, None, None, :]  # [1, 1, 1, T]
    qp = qpos.reshape(1, 1, C, 1)
    s = torch.einsum("chgd,thd->hgct", q.float(), k)
    out = masked_softmax_pv(s, kp, qp, v, "hgct,thd->chgd", scale=scale, causal=causal,
                            window=window, softcap=softcap)
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
) -> torch.Tensor:
    """[C, Hkv, G, dh] attention output in q's type."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, kpos, table, qpos, ck, cv,
                                             scale=scale, causal=causal, window=window,
                                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for device {q.device}")
    check_pool_args("paged_prefill_attention", q, k_pool, v_pool, kpos, table, qpos,
                    extra=(("ck", ck), ("cv", cv)))
    C, Hkv, G, dh = q.shape
    Pt, ps = kpos.shape
    if table.ndim != 1 or qpos.shape != (C,) or ck.shape != (C, Hkv, dh) or cv.shape != ck.shape:
        raise ValueError(f"paged_prefill_attention: table {tuple(table.shape)}, qpos "
                         f"{tuple(qpos.shape)}, ck {tuple(ck.shape)}, cv {tuple(cv.shape)} "
                         f"do not match q {tuple(q.shape)}")
    lib = _library()
    fn = lib.paged_prefill_attention_bf16 if q.dtype == torch.bfloat16 else lib.paged_prefill_attention_f32
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), kpos.data_ptr(),
                 table.data_ptr(), qpos.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
                 C, Hkv, G, dh, ps, table.shape[0], Pt, float(scale), int(causal), int(window),
                 float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention: kernel launch failed with CUDA error {err}")
    launches["paged_prefill_attention"] += 1
    return out
