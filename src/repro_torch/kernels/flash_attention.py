"""Flash attention: the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/flash_attention.py::flash_attention``
(the TPU kernel, kernel 6); its design and bound are in the source's note.
Two entry points launch it:

- ``flash_attention(q, k, v, *, scale, causal)`` over ``[BH, S, dh]``: the
  TPU kernel's own contract.  Its causal mask is by index, so it is
  top-left aligned: query i sees keys 0 .. i whatever T is (the JAX
  ``flash_attention_ref`` aligns bottom-right, ``tril(k=T-S)``; the two agree
  when S == T).
- ``flash_attention_gqa(q, k, v, q_pos, k_pos, *, scale, causal, window,
  softcap)`` over the model's layouts, q ``[B, S, H, dh]`` and k / v
  ``[B, T, Hkv, dh]`` with ``H = G * Hkv``, masks from int32 positions: what
  the model's ``attend_full`` computes (``models/attention.py``).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  ``launches`` counts the wrapper's kernel launches.

Training (kernel 6b, ``csrc/flash_attention_bwd.cu``): under grad, with q,
k or v requiring it, ``flash_attention_gqa`` goes through
``FlashAttentionFn``, whose forward launches kernel 6 with its optional row
log-sum-exp output L [B, H, S] (f32; null on every serving path, whose
launch is unchanged) and whose backward launches kernel 6b
(``flash_attention_backward``): the gradients of q, k and v that
``jax.value_and_grad`` takes of the model's attention.  On the CPU the
same function runs the plain versions (``flash_attention_plain`` with
``return_lse``, ``flash_attention_backward_plain``).  In bf16 kernel 6b
runs on the tensor cores over 64-key and 64-query tiles
(``BWD_TILE``): its dK / dV pass walks the query tiles that
``query_tile_marks`` marks, and splits a kv-head's G query heads across
``backward_head_splits`` blocks where its grid would leave SMs idle
(f32 partials in a workspace the wrapper allocates, summed in order);
``backward_blocks`` asks the built library for each pass's block count.
f32 keeps the CUDA-core kernels.

Both versions zero masked probabilities, as ``masked_softmax_pv`` does
(``kernels/attention_paged.py``), so a row with no valid key gives 0.  The
JAX ``_sdpa`` gives such a row a uniform average over its keys instead;
rows with a valid key agree, and every static or forward query sees itself.
The plain version attends ``q_chunk`` queries at a time (default
``Q_CHUNK``), so its f32 logits are ``[B, Hkv, G, q_chunk, T]``, never
``[.., S, T]``; the kernel tiles the queries itself (one call for the whole
S).

In bf16 at head dims 64, 128 and 256 (``WGMMA_HEAD_DIMS``) the kernel runs
on wgmma with K/V through TMA: it takes ``q_tile_rows`` query rows per
block (always 128 at dh 256) over K/V tiles of ``kv_tile_keys``, marks the
key tiles its rows may see from per-128-key summaries that a first launch
writes into a workspace the wrapper allocates (``tile_summaries`` and
``summary_marks`` in plain PyTorch, ``kv_tile_marks`` for 64-key tiles; a
row of at most ``ONE_TILE_KEYS`` keys is one tile and takes neither), and
reads q, k and v through 4-D tensor maps (``tensor_map_args``: a row is
dh / 64 boxes), which need 16-byte aligned bases and strides
(``check_tma``).  Head dims 32 and 112 (no served config) keep the
``mma.sync`` kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention_paged import _sm_count
from repro_torch.kernels import account

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 112, 128, 256)  # head dims the kernel is instantiated for
Q_CHUNK = 1024  # the plain version's query chunk (the JAX package's Q_CHUNK)
MAX_KEYS = 128 * 32 * 64  # csrc/flash_attention.cu: the live-tile bitmask's reach
WGMMA_HEAD_DIMS = (64, 128, 256)  # bf16 head dims on wgmma + TMA; 32 and 112 keep mma.sync
KEY_TILE = 128  # keys per tile summary, and per K/V tile of 128-row blocks (64 at 64 rows, dh 256)
ONE_TILE_KEYS = 64  # rows of at most this many keys: one tile, no summaries
BOX_COLS = 64  # columns of a TMA box: 128 bytes of bf16, the swizzle's span
BWD_TILE = 64  # csrc/flash_attention_bwd.cu, bf16: keys per key tile, queries per query tile

launches = {"flash_attention": 0, "flash_attention_backward": 0}

_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_C_ARGS_BF16 = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + _TAIL  # + summ, lse, q_tile
_C_ARGS_F32 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + _TAIL  # + lse
_C_ARGS_BWD = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + _TAIL  # + part; + is_bf16, splits


def _library():
    lib = build.load_library("flash_attention")
    for fn, args in ((lib.flash_attention_bf16, _C_ARGS_BF16), (lib.flash_attention_f32, _C_ARGS_F32)):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _backward_library():
    lib = build.load_library("flash_attention_bwd")
    lib.flash_attention_backward.argtypes = _C_ARGS_BWD
    lib.flash_attention_backward.restype = ctypes.c_int
    lib.flash_attention_backward_blocks.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.flash_attention_backward_blocks.restype = ctypes.c_int
    return lib


def q_tile_rows(S: int, H: int, B: int, n_sm: int, dh: int = 128) -> int:
    """Query rows per block of the wgmma path: 128 (two consumer
    warpgroups, 128-key tiles, one block per SM), or 64 (one warpgroup,
    64-key tiles, two blocks per SM) where S fits one 64-row tile (the
    served 4 x 64 prefill, whose 128-row tiles would be half empty and take
    two waves of the card) or where 128-row tiles would give fewer blocks
    than the card has SMs.  Head dim 256 always takes 128: a 64-row block
    would need 160 KB of shared memory, one block per SM, and gain
    nothing."""
    if dh == 256:
        return 128
    return 64 if S <= 64 or -(-S // 128) * H * B < n_sm else 128


def kv_tile_keys(dh: int, q_tile: int) -> int:
    """Keys per K/V tile of the wgmma path (``WgCfg::BN``): 128 under
    128-row blocks, 64 under 64-row blocks and at head dim 256 (two stages
    of 128 keys would need 320 KB there)."""
    return 64 if dh == 256 or q_tile == 64 else 128


def tensor_map_args(shape, box_rows: int, elem_bytes: int = 2) -> tuple:
    """The 4-D TMA map the kernel encodes over a ``[B, N, heads, dh]``
    tensor (q: N = S; k, v: N = T): dims innermost first, the byte strides
    of dims 1-3, and the box (64 columns x 1 head x ``box_rows`` rows x 1
    batch row); a row is dh / 64 boxes, loaded one box at a time."""
    B, N, heads, dh = shape
    dims = (dh, heads, N, B)
    strides = (dh * elem_bytes, heads * dh * elem_bytes, N * heads * dh * elem_bytes)
    return dims, strides, (BOX_COLS, 1, box_rows, 1)


def tile_summaries(k_pos: torch.Tensor, tile: int = KEY_TILE) -> torch.Tensor:
    """The first launch of a long row in plain PyTorch: per ``tile`` keys of
    each batch row, ``[min, max, count]`` of the valid positions (>= 0);
    keys past T count as invalid, an empty tile is ``[INT32_MAX, INT32_MIN,
    0]``.  [B, ceil(T / tile), 3] int64."""
    B, T = k_pos.shape
    n = -(-T // tile)
    kp = torch.full((B, n * tile), -1, dtype=torch.int64)
    # analysis: allow(host-asarray) — host mirror of the tile summaries, not on the card path
    kp[:, :T] = k_pos.to(torch.int64).cpu()
    kp = kp.view(B, n, tile)
    valid = kp >= 0
    big, small = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min
    lo = torch.where(valid, kp, big).amin(-1)
    hi = torch.where(valid, kp, small).amax(-1)
    return torch.stack([lo, hi, valid.sum(-1)], -1)


def summary_marks(summ: torch.Tensor, q_lo: int, q_hi: int, *, tile: int = KEY_TILE,
                  causal: bool = True, window: int = 0) -> tuple:
    """A block's marks from its row's summaries, as the kernel sets them for
    query positions in [q_lo, q_hi]: ``live`` (may hold a key valid for some
    row: min and max stand for the keys, so at worst a tile is loaded and
    masked) and ``full`` (every key valid for every row, exactly).  Boolean
    [n] each."""
    lo, hi, count = summ.unbind(-1)
    live = count > 0
    full = count == tile
    if causal:
        live = live & (lo <= q_hi)
        full = full & (hi <= q_lo)
    if window > 0:
        live = live & (hi > q_lo - window)
        full = full & (lo > q_hi - window)
    return live, full


def kv_tile_marks(summ: torch.Tensor, q_lo: int, q_hi: int, n_tiles: int, *, tile: int,
                  causal: bool = True, window: int = 0) -> tuple:
    """The marks of a row's ``n_tiles`` K/V tiles of ``tile`` keys (64 or
    128) from its per-``KEY_TILE`` summaries, as the kernel sets them: tile
    j takes the marks of summary j * tile // KEY_TILE (``summary_marks``),
    so a 64-key half of a live summary tile may be loaded and masked, and a
    half of a full one is full.  Boolean [n_tiles] each."""
    live, full = summary_marks(summ, q_lo, q_hi, causal=causal, window=window)
    idx = torch.arange(n_tiles) * tile // KEY_TILE
    return live[idx], full[idx]


def query_tile_marks(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool = True,
                     window: int = 0, tile: int = BWD_TILE) -> tuple:
    """Kernel 6b's dK / dV pass marks in plain PyTorch, as its
    ``mark_query_tiles`` sets them for one key tile: for each of the
    ceil(S / ``tile``) query tiles of a batch row's positions ``q_pos`` [S],
    ``live`` (some query may pair validly with some valid key of the tile:
    the valid keys' min and max stand for them, so at worst a tile is
    walked and masked) and ``full`` (every query pairs validly with every
    key, exactly).  ``k_pos``: the key tile's positions, -1 for an empty
    slot; a tile of fewer than ``tile`` keys (a row's last, past T) is never
    full, and one without a valid key marks nothing.  Boolean [n] each."""
    S = q_pos.shape[0]
    n = -(-S // tile)
    # analysis: allow(host-asarray) — host mirror of the kernel's tile marks, not on the card path
    kp = k_pos.to(torch.int64).cpu()
    valid = kp >= 0
    kn = int(valid.sum())
    if kn == 0:
        return torch.zeros(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool)
    klo, khi = int(kp[valid].min()), int(kp[valid].max())
    # analysis: allow(host-asarray) — the same
    qp = q_pos.to(torch.int64).cpu()
    may = torch.ones(S, dtype=torch.bool)
    every = torch.ones(S, dtype=torch.bool)
    if causal:
        may &= qp >= klo
        every &= qp >= khi
    if window > 0:
        may &= qp - khi < window
        every &= qp - klo < window
    pad = n * tile - S  # queries past S do not count
    live = torch.nn.functional.pad(may, (0, pad), value=False).view(n, tile).any(-1)
    full = torch.nn.functional.pad(every, (0, pad), value=True).view(n, tile).all(-1)
    return live, full & (kn == tile)


def backward_head_splits(T: int, Hkv: int, B: int, G: int, n_sm: int) -> int:
    """Blocks over which kernel 6b's bf16 dK / dV pass splits the G query
    heads of a kv-head: 1 where its grid of ceil(T / 64) key tiles x Hkv x
    B blocks fills the card's ``n_sm`` SMs, else as many as bring the grid
    to ``n_sm`` blocks, at most G (one head a block).  Static shapes only,
    so a call can be captured in a CUDA graph."""
    base = -(-T // BWD_TILE) * Hkv * B
    return 1 if base >= n_sm else min(G, -(-n_sm // base))


def backward_blocks(B: int, S: int, T: int, H: int, Hkv: int, dh: int, dtype, n_sm: int) -> dict:
    """Kernel 6b's blocks per pass for a call on a card of ``n_sm`` SMs, as
    its launches size their grids (the library's
    ``flash_attention_backward_blocks``; needs the built library): the D
    pass, dK / dV (with its head splits), the sum of the splits' partials
    (0 where it is not launched) and dQ."""
    bf16 = dtype == torch.bfloat16
    splits = backward_head_splits(T, Hkv, B, H // Hkv, n_sm) if bf16 else 1
    out = (ctypes.c_longlong * 4)()
    if _backward_library().flash_attention_backward_blocks(B, S, T, H, Hkv, dh, int(bf16), splits,
                                                           out) != 0:
        raise ValueError(f"backward_blocks: no kernel for B {B}, S {S}, T {T}, H {H}, Hkv {Hkv}, "
                         f"dh {dh}, {dtype}")
    return {"delta": out[0], "dkv": out[1], "sum_splits": out[2], "dq": out[3], "splits": splits,
            "sm": n_sm}


def check_tma(name, **tensors):
    """TMA reads a tensor map only from a 16-byte aligned base with strides
    in multiples of 16 bytes: raise for a tensor that breaks either (the
    strides of a contiguous ``[B, N, heads, dh]`` tensor are multiples of a
    row's ``dh`` values, ``tensor_map_args``; positions are read as one 1-D
    map, which needs the base alone aligned)."""
    for n, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be aligned to 16 bytes for TMA")
        if t.dim() == 4 and t.shape[-1] * t.element_size() % 16:
            raise ValueError(f"{name}: {n}'s rows of {t.shape[-1]} values are not multiples of 16 "
                             "bytes")


def _chunk_scores(qc, kf, q_pos_c, k_pos, *, scale, causal, window, softcap):
    """f32 scores [B, Hkv, G, c, T] of a chunk of queries (scaled, then
    softcapped, as the model's ``_sdpa``) and their validity mask."""
    B, c, H, dh = qc.shape
    Hkv = kf.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", qc.reshape(B, c, Hkv, H // Hkv, dh).float(), kf)
    s.mul_(scale)
    if softcap > 0.0:
        s = torch.tanh(s.div_(softcap)).mul_(softcap)
    kp = k_pos[:, None, None, None, :]  # [B, 1, 1, 1, T]
    qp = q_pos_c[:, None, None, :, None]  # [B, 1, 1, c, 1]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window > 0:
        valid = valid & (qp - kp < window)
    return s, valid


def flash_attention_plain(q, k, v, q_pos, k_pos, *, scale: float, causal: bool = True,
                          window: int = 0, softcap: float = 0.0, q_chunk: int = Q_CHUNK,
                          return_lse: bool = False):
    """The kernel's function in PyTorch, as the model's ``_sdpa`` computes
    it (f32 logits scaled, softcapped and masked, f32 softmax, probabilities
    cast to v's type for the P.V product) with masked entries zeroed, over
    ``q_chunk`` queries at a time.  ``return_lse`` also returns the row
    log-sum-exp L [B, H, S] f32 over the valid keys (+inf for a row with
    none), kernel 6's optional output."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float()
    out = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, S), dtype=torch.float32, device=q.device) if return_lse else None
    for s0 in range(0, S, q_chunk):
        qc = q[:, s0 : s0 + q_chunk]
        c = qc.shape[1]
        s, valid = _chunk_scores(qc, kf, q_pos[:, s0 : s0 + c], k_pos, scale=scale, causal=causal,
                                 window=window, softcap=softcap)
        s.masked_fill_(~valid, NEG_INF)
        if return_lse:
            lc = torch.logsumexp(s, dim=-1)
            lse[..., s0 : s0 + c] = torch.where(valid.any(-1), lc, float("inf"))
        p = torch.softmax(s, dim=-1)
        del s
        p.masked_fill_(~valid, 0.0)
        y = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
        out[:, s0 : s0 + c] = y.reshape(B, c, H, dh)
    if return_lse:
        return out, lse.view(B, H, S)
    return out


def flash_attention_backward_plain(q, k, v, q_pos, k_pos, out, dout, lse, *, scale: float,
                                   causal: bool = True, window: int = 0, softcap: float = 0.0,
                                   q_chunk: int = Q_CHUNK):
    """Kernel 6b's function in PyTorch: (dq, dk, dv) in the types of q, k
    and v, from the forward's output ``out``, its row log-sum-exp ``lse``
    [B, H, S] and ``dout``.  P = exp(z - L) on valid keys (0 elsewhere),
    D = rowsum(dO * O), dV = P^T dO with P rounded to v's type (the
    forward's P.V operand), dZ = P * (dO V^T - D) (times 1 - (z / c)^2
    under a softcap c), dQ = scale dZ K, dK = scale dZ^T Q, summed over a
    kv-head's G query heads; f32 throughout, over ``q_chunk`` queries at a
    time."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    L = lse.view(B, Hkv, G, S)
    delta = torch.einsum("bshd,bshd->bhs", dout.float(), out.float()).reshape(B, Hkv, G, S)
    for s0 in range(0, S, q_chunk):
        qc = q[:, s0 : s0 + q_chunk]
        c = qc.shape[1]
        z, valid = _chunk_scores(qc, kf, q_pos[:, s0 : s0 + c], k_pos, scale=scale, causal=causal,
                                 window=window, softcap=softcap)
        p = torch.exp(z - L[..., s0 : s0 + c, None]).masked_fill_(~valid, 0.0)
        doc = dout[:, s0 : s0 + c].float().reshape(B, c, Hkv, G, dh)
        dv += torch.einsum("bkgst,bskgd->btkd", p.to(v.dtype).float(), doc)
        dp = torch.einsum("bskgd,btkd->bkgst", doc, vf)
        dz = p * (dp - delta[..., s0 : s0 + c, None])
        if softcap > 0.0:
            dz.mul_(1.0 - (z / softcap) ** 2)
        dq[:, s0 : s0 + c] = torch.einsum("bkgst,btkd->bskgd", dz, kf).reshape(B, c, H, dh) * scale
        dk += torch.einsum("bkgst,bskgd->btkd", dz, qc.float().reshape(B, c, Hkv, G, dh)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, q_pos, k_pos):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {q.dtype} not supported (bfloat16, float32)")
    for n, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if t.device != q.device:
            raise ValueError(f"{name}: {n} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError(f"{name}: q_pos and k_pos must be int32")
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, T, Hkv, dh) or v.shape != k.shape or q_pos.shape != (B, S)
            or k_pos.shape != (B, T) or H % Hkv):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"q_pos {tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)} do not match")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} has no kernel instance (have {HEAD_DIMS})")
    if not 1 <= T <= MAX_KEYS or S < 1:
        raise ValueError(f"{name}: {S} queries over {T} keys; the kernel takes 1 to {MAX_KEYS} keys")


def flash_attention_gqa(
    q: torch.Tensor,  # [B, S, H, dh]
    k: torch.Tensor,  # [B, T, Hkv, dh]
    v: torch.Tensor,  # [B, T, Hkv, dh]
    q_pos: torch.Tensor,  # [B, S] int32
    k_pos: torch.Tensor,  # [B, T] int32, -1 = empty slot
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """[B, S, H, dh] attention output in q's type; head h reads kv-head
    h // G.  Differentiable (``FlashAttentionFn``) when grad is enabled and
    q, k or v requires it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_pos, k_pos, scale, causal, window, softcap)
    return _forward(q, k, v, q_pos, k_pos, scale=scale, causal=causal, window=window,
                    softcap=softcap)


class FlashAttentionFn(torch.autograd.Function):
    """Kernel 6 with its L output, and kernel 6b as its backward (their
    plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, causal, window, softcap):
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
        out, lse = _forward(q, k, v, q_pos, k_pos, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, q_pos, k_pos, out, dout.contiguous(), lse,
                                              **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_backward(q, k, v, q_pos, k_pos, out, dout, lse, *, scale: float,
                             causal: bool = True, window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention_gqa`` at ``dout``, from its output
    and row log-sum-exp: kernel 6b on the card (one count a call: its D
    pass, dK / dV pass, the sum of its head splits' partials where it splits
    and its dQ pass; bf16 on the tensor cores, f32 on the CUDA cores), the
    plain version on the CPU."""
    if account.recorder is not None:
        return account.recorder.kernel("flash_attention_backward", flash_attention_backward,
                                       **locals())
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, q_pos, k_pos, out, dout, lse, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: no kernel for device {q.device}")
    name = "flash_attention_backward"
    _check(name, q, k, v, q_pos, k_pos)
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    for n, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous {q.dtype} tensor of q's shape")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous [B, H, S] float32 tensor")
    if S > MAX_KEYS:
        raise ValueError(f"{name}: {S} queries; the kernel takes at most {MAX_KEYS}")
    lib = _backward_library()
    bf16 = q.dtype == torch.bfloat16
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    splits = backward_head_splits(T, Hkv, B, H // Hkv, _sm_count(q.device.index)) if bf16 else 1
    part = (torch.empty((2, splits, B, T, Hkv, dh), dtype=torch.float32, device=q.device)
            if splits > 1 else None)  # the splits' f32 partials of dK and dV
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), part.data_ptr() if part is not None else None, B, S, T,
            H, Hkv, dh, int(bf16), splits, float(scale), int(causal), int(window), float(softcap),
            stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1
    return dq, dk, dv


def _forward(q, k, v, q_pos, k_pos, *, scale: float, causal: bool, window: int, softcap: float,
             return_lse: bool = False):
    """Kernel 6 (its plain version on the CPU); ``return_lse``: also the row
    log-sum-exp [B, H, S] f32, which the launch then writes."""
    if account.recorder is not None:
        return account.recorder.kernel("flash_attention", _forward, **locals())
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, k_pos, scale=scale, causal=causal,
                                     window=window, softcap=softcap, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    name = "flash_attention"
    _check(name, q, k, v, q_pos, k_pos)
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    lib = _library()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    lse_ptr = lse.data_ptr() if lse is not None else None
    if q.dtype == torch.bfloat16:
        fn, summ, q_tile = lib.flash_attention_bf16, None, 0
        if dh in WGMMA_HEAD_DIMS:
            check_tma(name, q=q, k=k, v=v, k_pos=k_pos)
            q_tile = q_tile_rows(S, H, B, _sm_count(q.device.index), dh)
            if T > ONE_TILE_KEYS:  # tile summaries {min, max, count} per 128 keys of each row
                summ = torch.empty((B, -(-T // KEY_TILE), 4), dtype=torch.int32, device=q.device)
        ptrs = (out.data_ptr(), summ.data_ptr() if summ is not None else None, lse_ptr)
        shapes = (B, S, T, H, Hkv, dh, q_tile)
    else:
        fn, ptrs, shapes = lib.flash_attention_f32, (out.data_ptr(), lse_ptr), (B, S, T, H, Hkv, dh)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                 *ptrs, *shapes, float(scale), int(causal), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1
    return (out, lse) if return_lse else out


def flash_attention(
    q: torch.Tensor,  # [BH, S, dh]
    k: torch.Tensor,  # [BH, T, dh]
    v: torch.Tensor,  # [BH, T, dh]
    *,
    scale: float,
    causal: bool = True,
) -> torch.Tensor:
    """The TPU kernel's contract: [BH, S, dh] in q's type, causal by index
    (query i sees keys 0 .. i, top-left aligned)."""
    BH, S, _ = q.shape
    T = k.shape[1]
    pos = lambda n: torch.arange(n, dtype=torch.int32, device=q.device).expand(BH, n).contiguous()
    out = flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None], pos(S), pos(T),
                              scale=scale, causal=causal)
    return out[:, :, 0]
