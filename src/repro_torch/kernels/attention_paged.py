"""Paged decode attention: the wrapper of the hand-written Hopper kernel
``csrc/paged_decode_attention.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/attention_paged.py::paged_decode_attention``
(the TPU kernel), both its branches: a full-precision pool (kernel 7) and an
int8 pool with f32 scales per (key, kv-head) (``k_scale``/``v_scale`` given,
kernel 7q).  Its design and bound are in the source's note and in
``csrc/paged_mma.cuh`` (bf16) and ``csrc/paged_attention.cuh`` (f32).  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or raises.  ``launches`` counts the wrapper's kernel calls per branch, one per
call whatever the CUDA launches inside (two in bf16), so a run can show that
its main path went through the kernel.

Over an int8 pool the plain version dequantizes to the query's type, as the
JAX reference path does (``materialize_kv``); the kernel computes in f32 with
the f32 scales, as the TPU kernel does (in bf16 it applies them to its
products: K's to the scores, V's to the probabilities).  In f32 the two are
the same; in bf16 they differ by one bf16 rounding of each K/V value, and the
kernel rounds the probabilities to bf16 for P.V on the tensor cores.

Both versions compute one function: masked entries get probability 0, so a
row with no valid key (an inactive slot, whose table row is all trash) gives
0, finite.  The JAX package's ``paged_decode_attention_ref`` gives such a row
a uniform average instead; rows with a valid key agree.

In bf16 the kernel splits each row's live key tiles over ``decode_splits``
blocks (``split_bounds``), which write f32 partials (running max m,
normaliser l, unnormalised accumulator) that a second launch merges;
``masked_partials`` and ``merge_partials`` are that arithmetic in plain
PyTorch, for the CPU tests.  The plain version itself does not split.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant.kv import QuantizedKV
from repro_torch.kernels.no_backward import SERVING_KERNELS, refuse_grad
from repro_torch.kernels import account

NEG_INF = -1e30
KEYS_PER_TILE = 32  # paged_attention.cuh KT: a page must fit in one f32 tile
TILE_KEYS = 64  # paged_mma.cuh BK: keys per tile of the bf16 kernels
HEAD_DIMS = (32, 64, 128)  # head dims the kernels are instantiated for
MAX_G = 16  # query heads per kv-head in one decode block
MAX_SPLITS_DH256 = 32  # csrc/decode_attention_quant.cu d256::MAX_SPLITS

launches = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0}

_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_C_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + _TAIL  # f32: unsplit
_C_ARGS_SPLIT = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + _TAIL  # bf16: + ws, splits


def _library():
    lib = build.load_library("paged_decode_attention")
    scales = [ctypes.c_void_p] * 2  # the int8 entries take the two scale pointers first
    for fn, args in ((lib.paged_decode_attention_bf16, _C_ARGS_SPLIT),
                     (lib.paged_decode_attention_f32, _C_ARGS),
                     (lib.paged_decode_attention_int8_bf16, scales + _C_ARGS_SPLIT),
                     (lib.paged_decode_attention_int8_f32, scales + _C_ARGS)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_splits(nt: int, ps: int, B: int, Hkv: int, n_sm: int, dh: int = 0) -> int:
    """Blocks over which the bf16 kernel splits each row's live key tiles,
    from static shapes only (no read of a device value, so the call can be
    captured in a CUDA graph): about two blocks per SM over the B * Hkv
    (slot, kv-head) pairs, and no more splits than a row has 64-key tiles.
    At head dim 256 (kernel 9's kernel of its own) one wave of one block per
    SM instead, fewer and heavier splits: a block walks several tiles with
    the next one in flight, and the partials a second launch merges
    shrink; at most ``MAX_SPLITS_DH256``, the merge's reach."""
    tiles = -(-nt * ps // TILE_KEYS)
    if dh == 256:
        want = min(n_sm // (B * Hkv), MAX_SPLITS_DH256)
    else:
        want = -(-2 * n_sm // (B * Hkv))
    return max(1, min(want, tiles))


def split_bounds(n: int, splits: int) -> list:
    """The ranks [lo, hi) among n live 64-key tiles (a row's live pages,
    compacted, 64 keys a tile) that each split takes, as the kernels' blocks
    compute them on the card."""
    return [(s * n // splits, (s + 1) * n // splits) for s in range(splits)]


def tile_marks(k_pos: torch.Tensor, q_lo: int, q_hi: int, *, tile: int, causal: bool = True,
               window: int = 0) -> tuple:
    """A block's marks over one row's key positions ``k_pos`` [T], as the
    contiguous kernels (6's wgmma path, 128- or 64-key tiles; 9, 64-key
    tiles) set them for query positions in [q_lo, q_hi], key by key: ``live``
    (a key valid for some query position in the range; the other tiles are
    never loaded) and ``full`` (every key valid for every one: no per-entry
    mask); keys past T are invalid.  Boolean [ceil(T / tile)] each."""
    T = k_pos.shape[-1]
    n = -(-T // tile)
    kp = torch.full((n * tile,), -1, dtype=torch.int64)
    # analysis: allow(host-asarray) — host mirror of the kernel's tile walk, not on the card path
    kp[:T] = k_pos.reshape(-1).to(torch.int64).cpu()
    kp = kp.view(n, tile)
    live = kp >= 0
    full = kp >= 0
    if causal:
        live = live & (kp <= q_hi)
        full = full & (kp <= q_lo)
    if window > 0:
        live = live & (kp > q_lo - window)
        full = full & (kp > q_hi - window)
    return live.any(-1), full.all(-1)


def kv_values(x, scale, dtype):
    """Gathered cache values as f32: fp values widened, or int8 values
    dequantized to ``dtype`` (``materialize_kv``), then widened."""
    if scale is None:
        return x.float()
    return QuantizedKV(x, scale, dtype).dequantize().float()


def scores_and_mask(s, kp, qp, *, scale, causal, window, softcap):
    """Scores ``s`` (f32 q.k) scaled and softcapped, and which entries are
    valid: key positions ``kp`` against query positions ``qp`` (kp >= 0,
    causal, window)."""
    s = s * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window > 0:
        valid = valid & (qp - kp < window)
    return s, valid


def masked_softmax_pv(s, kp, qp, v, pv: str, *, scale, causal, window, softcap):
    """The kernels' arithmetic in plain PyTorch: ``scores_and_mask``, softmax
    with masked entries zeroed, then ``einsum(pv, p, v)`` in f32."""
    s, valid = scores_and_mask(s, kp, qp, scale=scale, causal=causal, window=window,
                               softcap=softcap)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum(pv, p, v)


def masked_partials(s, kp, qp, v, pv: str, *, scale, causal, window, softcap):
    """One split's share of ``masked_softmax_pv``, as a split block writes it:
    the running max ``m`` over the valid entries (NEG_INF where none is), the
    normaliser ``l = sum exp(s - m)`` and the unnormalised ``einsum(pv, p,
    v)``, all in f32 (``pv`` keeps the scores' row axes first, so m, l and
    acc share them).  A key outside the split is one whose ``kp`` is -1."""
    s, valid = scores_and_mask(s, kp, qp, scale=scale, causal=causal, window=window,
                               softcap=softcap)
    m = torch.where(valid, s, NEG_INF).amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum(pv, p, v)


def merge_partials(m, l, acc):
    """The merge kernel's arithmetic: partials of disjoint key sets, the split
    axis first (``m``, ``l`` [S, ...], ``acc`` [S, ..., dh]), merged as
    ``sum_s acc_s e^(m_s - m*) / sum_s l_s e^(m_s - m*)`` with ``m* = max_s
    m_s``.  A split with no valid key (m = NEG_INF, l = 0, acc = 0) adds
    nothing; a row with none in any split gives 0."""
    w = torch.exp(m - m.amax(0))
    return (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp_min(1e-30)[..., None]


DECODE_PV = "bhgt,bthd->bhgd"


def decode_scores(q, k_pool, v_pool, kpos, table, qpos, k_scale=None, v_scale=None):
    """The plain version's gather: the table's pages as a contiguous history
    of T = nt * ps keys (dequantized, for an int8 pool), and (f32 q.k scores
    [B, Hkv, G, T], key positions [B, 1, 1, T], query positions [B, 1, 1, 1],
    f32 values [B, T, Hkv, dh]); key t is entry t // ps of its row."""
    B, Hkv, G, dh = q.shape
    ps = k_pool.shape[1]
    idx = table.long()
    nt = idx.shape[1]
    gather = lambda pool, n: None if pool is None else pool[idx].reshape(B, nt * ps, Hkv, n)
    k = kv_values(gather(k_pool, dh), gather(k_scale, 1), q.dtype)
    v = kv_values(gather(v_pool, dh), gather(v_scale, 1), q.dtype)
    kp = kpos[idx].reshape(B, 1, 1, nt * ps)
    qp = qpos.reshape(B, 1, 1, 1)
    return torch.einsum("bhgd,bthd->bhgt", q.float(), k), kp, qp, v


def paged_decode_attention_plain(q, k_pool, v_pool, kpos, table, qpos, *, scale: float,
                                 causal: bool = True, window: int = 0, softcap: float = 0.0,
                                 k_scale=None, v_scale=None):
    """The kernel's function in PyTorch, as ``paged_decode_attention_ref``
    computes it: ``decode_scores``, then a masked f32 softmax over the
    history."""
    s, kp, qp, v = decode_scores(q, k_pool, v_pool, kpos, table, qpos, k_scale, v_scale)
    out = masked_softmax_pv(s, kp, qp, v, DECODE_PV, scale=scale, causal=causal, window=window,
                            softcap=softcap)
    return out.to(q.dtype)


def check_kv_args(name, q, k, v, k_scale, v_scale, extra=(), head_dims=HEAD_DIMS):
    """Checks of the K/V a kernel reads: the cache ``k``/``v`` in q's type,
    or int8 with f32 scales ``[..., 1]`` matching them; ``extra`` are
    further (name, tensor) pairs in q's type (the chunk's K/V); ``head_dims``
    the kernel's instances."""
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
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be aligned to 16 bytes")
    if quant:
        for n, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or t.shape != k.shape[:-1] + (1,):
                raise ValueError(f"{name}: {n} must be float32 of shape {tuple(k.shape[:-1]) + (1,)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[-1] not in head_dims:
        raise ValueError(f"{name}: head_dim {k.shape[-1]} not supported (kernels built for {head_dims})")


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
    if q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be aligned to 16 bytes")
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
    plan_rows: int = 0,
) -> torch.Tensor:
    """[B, Hkv, G, dh] attention output in q's type.  Caller contract as the
    TPU kernel's: the table is pre-clamped, and ``kpos`` is -1 for every
    entry not holding a valid token (trash page, fresh and recycled pages).
    With ``k_scale``/``v_scale`` the pool holds int8 values (kernel 7q).
    ``plan_rows`` (0: B) is the row count the split plan is made for: a
    rank's rows of a slot-sharded step take the whole step's plan, so each
    row's split-K sums, and its output bits, are one device's."""
    if account.recorder is not None:
        return account.recorder.kernel(
            "paged_decode_attention" + ("" if k_scale is None else "_int8"),
            paged_decode_attention, **locals())
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, kpos, table, qpos, scale=scale,
                                            causal=causal, window=window, softcap=softcap,
                                            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    refuse_grad("paged_decode_attention", SERVING_KERNELS, q, k_pool, v_pool, k_scale, v_scale)
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
    if bf16:  # split-K: f32 partials m, l, acc per (split, slot, kv-head, row)
        splits = decode_splits(nt, ps, plan_rows or B, Hkv, _sm_count(q.device.index))
        ws = (torch.empty(splits * B * Hkv * G * (dh + 2), dtype=torch.float32, device=q.device)
              if splits > 1 else None)  # one split writes out itself
        shapes = (out.data_ptr(), ws.data_ptr() if ws is not None else None, B, Hkv, G, dh, ps, nt,
                  Pt, splits)
    else:
        shapes = (out.data_ptr(), B, Hkv, G, dh, ps, nt, Pt)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), *kv, kpos.data_ptr(), table.data_ptr(), qpos.data_ptr(), *shapes,
                 float(scale), int(causal), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed with CUDA error {err}")
    launches[key] += 1
    return out
