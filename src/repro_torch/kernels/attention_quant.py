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

In bf16 the kernel splits each row's live 64-key tiles (those holding a
key the query sees, found by every block from the row's positions) over
``decode_splits`` blocks (from static shapes: ``ceil(T / 64)`` tiles; at
head dim 256, which has a kernel of its own, one wave of one block per SM),
which write f32 partials that a second launch merges, as kernel 7 does;
``live_tiles`` and ``split_tiles`` are its plan and
``decode_attention_quant_split`` its arithmetic in plain PyTorch, for the
CPU tests.  The plain version itself does not split.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.no_backward import SERVING_KERNELS, refuse_grad
from repro_torch.kernels.attention_paged import (DECODE_PV, MAX_G, TILE_KEYS, _sm_count,
                                                 check_kv_args, decode_splits, kv_values,
                                                 masked_partials, masked_softmax_pv, merge_partials,
                                                 split_bounds, tile_marks)
from repro_torch.kernels import account

launches = {"decode_attention_quant": 0}

WINDOW_TILES = 256  # paged_mma.cuh MAXL: a contiguous row's tiles marked and split per window
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernel is instantiated for (256: recurrentgemma)

_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_C_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + _TAIL  # f32: unsplit
_C_ARGS_SPLIT = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + _TAIL  # bf16: + ws, splits


def _library():
    lib = build.load_library("decode_attention_quant")
    for fn, args in ((lib.decode_attention_quant_bf16, _C_ARGS_SPLIT),
                     (lib.decode_attention_quant_f32, _C_ARGS)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def live_tiles(kpos_row, qpos: int, *, causal: bool = True, window: int = 0) -> list:
    """The 64-key tiles of one contiguous cache row that the bf16 kernel
    loads, from the positions alone, never from the slot index: those that
    hold a key valid for the query at ``qpos`` (``tile_marks``)."""
    live, _ = tile_marks(torch.as_tensor(kpos_row), qpos, qpos, tile=TILE_KEYS, causal=causal,
                         window=window)
    # analysis: allow(host-asarray) — host mirror of the kernel's split plan, not on the card path
    return torch.nonzero(live).flatten().tolist()


def split_tiles(kpos_row, qpos: int, splits: int, *, causal: bool = True, window: int = 0) -> list:
    """The tiles each of ``splits`` blocks of a row takes, as the kernel's
    blocks compute them: of each window of WINDOW_TILES tiles, the L live
    ones (``live_tiles``) go by rank, split s taking ``split_bounds(L,
    splits)[s]``."""
    live = live_tiles(kpos_row, qpos, causal=causal, window=window)
    out = [[] for _ in range(splits)]
    for w0 in range(0, max(live, default=-1) + 1, WINDOW_TILES):
        win = [j for j in live if w0 <= j < w0 + WINDOW_TILES]
        for s, (lo, hi) in enumerate(split_bounds(len(win), splits)):
            out[s] += win[lo:hi]
    return out


def decode_attention_quant_split(q, kq, ks, vq, vs, kpos, qpos, splits: int, *, scale: float,
                                 causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The bf16 kernel's split-K arithmetic in plain PyTorch, in f32: each
    split's partials (``masked_partials`` over the keys of its ``split_tiles``;
    every other key at position -1) merged by ``merge_partials``."""
    B, Hkv, G, dh = q.shape
    T = kq.shape[1]
    k = kv_values(kq, ks, q.dtype)
    v = kv_values(vq, vs, q.dtype)
    s = torch.einsum("bhgd,bthd->bhgt", q.float(), k)
    tile = torch.arange(T) // TILE_KEYS
    parts = []
    for sp in range(splits):
        taken = torch.zeros(B, T, dtype=torch.bool)
        for b in range(B):
            plan = split_tiles(kpos[b], int(qpos[b]), splits, causal=causal, window=window)
            taken[b] = torch.isin(tile, torch.tensor(plan[sp], dtype=torch.long))
        kp = torch.where(taken.to(kpos.device), kpos, -1).reshape(B, 1, 1, T)
        parts.append(masked_partials(s, kp, qpos.reshape(B, 1, 1, 1), v, DECODE_PV, scale=scale,
                                     causal=causal, window=window, softcap=softcap))
    return merge_partials(*(torch.stack(x) for x in zip(*parts)))


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
    if account.recorder is not None:
        return account.recorder.kernel("decode_attention_quant", decode_attention_quant, **locals())
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, kq, ks, vq, vs, kpos, qpos, scale=scale,
                                            causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant: no kernel for device {q.device}")
    refuse_grad("decode_attention_quant", SERVING_KERNELS, q, ks, vs)
    name = "decode_attention_quant"
    check_kv_args(name, q, kq, vq, ks, vs, head_dims=HEAD_DIMS)
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
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be aligned to 16 bytes")
    lib = _library()
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        fn = lib.decode_attention_quant_bf16
        splits = decode_splits(T, 1, B, Hkv, _sm_count(q.device.index), dh)
        # f32 partials m, l, acc per (split, slot, kv-head, row); one split
        # writes out itself
        ws = (torch.empty(splits * B * Hkv * G * (dh + 2), dtype=torch.float32, device=q.device)
              if splits > 1 else None)
        shapes = (out.data_ptr(), ws.data_ptr() if ws is not None else None, B, Hkv, G, dh, T,
                  splits)
    else:
        fn = lib.decode_attention_quant_f32
        shapes = (out.data_ptr(), B, Hkv, G, dh, T)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                 kpos.data_ptr(), qpos.data_ptr(), *shapes, float(scale), int(causal),
                 int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1
    return out
