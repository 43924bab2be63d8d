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

Both versions zero masked probabilities, as ``masked_softmax_pv`` does
(``kernels/attention_paged.py``), so a row with no valid key gives 0.  The
JAX ``_sdpa`` gives such a row a uniform average over its keys instead;
rows with a valid key agree, and every static or forward query sees itself.
The plain version attends ``q_chunk`` queries at a time (default
``Q_CHUNK``), so its f32 logits are ``[B, Hkv, G, q_chunk, T]``, never
``[.., S, T]``; the kernel tiles the queries itself (one launch for the
whole S).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 112, 128)  # head dims the kernel is instantiated for
Q_CHUNK = 1024  # the plain version's query chunk (the JAX package's Q_CHUNK)
MAX_KEYS = 128 * 32 * 64  # csrc/flash_attention.cu: the live-tile bitmask's reach

launches = {"flash_attention": 0}

_C_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
           + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _library():
    lib = build.load_library("flash_attention")
    for fn in (lib.flash_attention_bf16, lib.flash_attention_f32):
        fn.argtypes = _C_ARGS
        fn.restype = ctypes.c_int
    return lib


def flash_attention_plain(q, k, v, q_pos, k_pos, *, scale: float, causal: bool = True,
                          window: int = 0, softcap: float = 0.0, q_chunk: int = Q_CHUNK):
    """The kernel's function in PyTorch, as the model's ``_sdpa`` computes
    it (f32 logits scaled, softcapped and masked, f32 softmax, probabilities
    cast to v's type for the P.V product) with masked entries zeroed, over
    ``q_chunk`` queries at a time."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float()
    kp = k_pos[:, None, None, None, :]  # [B, 1, 1, 1, T]
    out = torch.empty_like(q)
    for s0 in range(0, S, q_chunk):
        qc = q[:, s0 : s0 + q_chunk]
        c = qc.shape[1]
        s = torch.einsum("bskgd,btkd->bkgst", qc.reshape(B, c, Hkv, G, dh).float(), kf)
        s.mul_(scale)
        if softcap > 0.0:
            s = torch.tanh(s.div_(softcap)).mul_(softcap)
        qp = q_pos[:, s0 : s0 + c][:, None, None, :, None]  # [B, 1, 1, c, 1]
        valid = kp >= 0
        if causal:
            valid = valid & (kp <= qp)
        if window > 0:
            valid = valid & (qp - kp < window)
        s.masked_fill_(~valid, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        p.masked_fill_(~valid, 0.0)
        y = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v)
        out[:, s0 : s0 + c] = y.reshape(B, c, H, dh)
    return out


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
    h // G."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, k_pos, scale=scale, causal=causal,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    name = "flash_attention"
    _check(name, q, k, v, q_pos, k_pos)
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    lib = _library()
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.flash_attention_f32
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                 out.data_ptr(), B, S, T, H, Hkv, dh, float(scale), int(causal), int(window),
                 float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1
    return out


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
