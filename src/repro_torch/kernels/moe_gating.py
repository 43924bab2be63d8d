"""Fused MoE gating with expert capacity: the wrapper of the hand-written
Hopper kernel ``csrc/moe_gating.cu`` and its plain PyTorch version.

The kernel replaces ``repro/kernels/moe_gating.py::gating_kernel`` (the TPU
kernel 1) and computes ``core/gating.py::top_k_gating``'s contract: f32
softmax, top-k with ties to the lower expert id, token-major positions in
each expert's capacity buffer, renormalised gates for K > 1, drops past the
capacity.  It also returns the per-expert assignment counts on the device,
which the capacity-buffer expert kernels read to skip empty experts (no host
sync).  The design and bound are in the source's note: up to
``ONE_LAUNCH_SLOTS`` slots (every served shape) one launch,
past it two.  A one-launch call of more than one block elects the block
that ranks with a ticket counter that no call running at the same time
shares (the source's ``ticket_word``: one per stream for eager calls, one
per stream of each CUDA graph capture), so calls may run on several
streams and graphs at once.  ``positions_scan_plain`` repeats its rank
scan's order on the CPU.  A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises.  ``launches`` counts the
wrapper's calls that launched the kernel, and ``variant_launches`` which
path each took (one launch, or two).

Training (kernel 1b, ``moe_gating_backward_f32`` in the same source): under
grad, with the logits requiring it, ``gating`` goes through ``GatingFn``,
whose backward maps the gradients of the gate weights and of the softmax
probabilities (the aux loss's) to the logits' (``gating_backward``; its
plain version ``gating_backward_plain`` on the CPU), as
``jax.value_and_grad`` differentiates ``top_k_gating``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.gating import Gating, count_ids, top_k_gating
from repro_torch.kernels import build

MAX_EXPERTS = 512  # 16 values per lane of the token's warp
MAX_TOP_K = 32  # gate k lives in lane k
# slots (T*K) up to which top-k and ranks run in one launch; every served
# shape is below it: T <= 264 at K = 1, and 256 x 8 at kimi-k2's width
ONE_LAUNCH_SLOTS = 4096
# the rank scan's chunk, one slot a thread of its block: up to 1024 in the
# rank launch, 32 a token up to 8 tokens in the one-launch path
RANK_THREADS = 1024

launches = {"moe_gating": 0, "moe_gating_backward": 0}
variant_launches = {"moe_gating_one_launch": 0, "moe_gating_two_launches": 0}

_C_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_C_ARGS_BWD = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_bound = None  # the loaded library whose signature is bound


def _library():
    global _bound
    lib = build.load_library("moe_gating")
    if lib is not _bound:
        lib.moe_gating_f32.argtypes = _C_ARGS
        lib.moe_gating_f32.restype = ctypes.c_int
        lib.moe_gating_backward_f32.argtypes = _C_ARGS_BWD
        lib.moe_gating_backward_f32.restype = ctypes.c_int
        _bound = lib
    return lib


def positions_scan_plain(flat_expert: torch.Tensor, num_experts: int,
                         chunk: int = RANK_THREADS) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's rank scan in its own order, on the CPU: slots in chunks
    of ``chunk`` (one slot a thread), each chunk in warps of 32; a slot's
    rank is its expert's carry from earlier chunks, plus the slots of its
    expert in the chunk's earlier warps, plus those on lower lanes of its
    own warp.  Returns (ranks [T*K], counts [E]), which must equal the
    stable ranks of ``top_k_gating`` and the per-expert counts."""
    ids = flat_expert.reshape(-1).long()
    n = ids.numel()
    ranks = torch.empty(n, dtype=torch.long)
    carry = torch.zeros(num_experts, dtype=torch.long)
    for base in range(0, n, chunk):
        c = ids[base: base + chunk]
        pad = -(-c.numel() // 32) * 32 - c.numel()
        w = torch.cat([c, torch.full((pad,), -1, dtype=torch.long)]).view(-1, 32)  # [warps, lanes]
        same = w[:, :, None] == w[:, None, :]  # [warp, lane, lane']
        lower = torch.tril(same, diagonal=-1).sum(-1)  # equal ids on lower lanes
        onehot = torch.zeros(w.shape[0], num_experts + 1, dtype=torch.long)
        onehot.scatter_add_(1, torch.where(w < 0, num_experts, w), torch.ones_like(w))
        per_warp = onehot[:, :num_experts]  # [warp, E]: the warp's slots of each expert
        before = torch.cumsum(per_warp, 0) - per_warp  # earlier warps of the chunk
        wi = torch.arange(w.shape[0])[:, None].expand_as(w)
        valid = w >= 0
        e = w.clamp(min=0)
        r = carry[e] + before[wi, e] + lower
        ranks[base: base + c.numel()] = r[valid]
        carry += per_warp.sum(0)
    return ranks, carry


def gating_plain(logits: torch.Tensor, top_k: int, capacity: int, *,
                 normalize: bool = True) -> Tuple[Gating, torch.Tensor]:
    """The kernel's function in PyTorch: ``top_k_gating`` (iterative masked
    argmax, so ties go to the lower id as in JAX; ranks by a stable sort),
    and the per-expert counts [E] int32 of all assignments."""
    g = top_k_gating(logits, top_k, capacity, normalize=normalize)
    return g, count_ids(g.expert_idx, logits.shape[-1]).to(torch.int32)


def gating(logits: torch.Tensor, top_k: int, capacity: int, *,
           normalize: bool = True) -> Tuple[Gating, torch.Tensor]:
    """logits [T, E] -> (``Gating``, counts [E] int32).  ``counts[e]`` is the
    number of (token, k) slots routed to expert e before capacity, so
    ``min(counts, capacity)`` rows of its buffer hold tokens.  On the card,
    one launch up to ``ONE_LAUNCH_SLOTS`` slots (T*K), two past it.
    Differentiable in the logits (``GatingFn``) when grad is enabled and
    they require it: ``combine_w`` and ``probs`` carry gradients."""
    one_launch = logits.shape[0] * top_k <= ONE_LAUNCH_SLOTS
    if torch.is_grad_enabled() and logits.requires_grad:
        eidx, w, pos, keep, probs, counts = GatingFn.apply(logits, top_k, capacity, normalize,
                                                           one_launch)
        return Gating(eidx, w, pos, keep, probs), counts
    return _gating(logits, top_k, capacity, normalize, one_launch)


class GatingFn(torch.autograd.Function):
    """Kernel 1 forward, kernel 1b backward (plain versions on the CPU).
    The outputs are copies of the kernel's one carved buffer, so each is a
    tensor of its own; ids, positions, keep and counts carry no gradient."""

    @staticmethod
    def forward(ctx, logits, top_k, capacity, normalize, one_launch):
        g, counts = _gating(logits, top_k, capacity, normalize, one_launch)
        outs = [t.clone() for t in (g.expert_idx, g.combine_w, g.position, g.keep, g.probs, counts)]
        eidx, _, pos, keep, probs, cnt = outs
        ctx.save_for_backward(probs, eidx, keep)
        ctx.normalize = normalize
        ctx.mark_non_differentiable(eidx, pos, keep, cnt)
        return tuple(outs)

    @staticmethod
    def backward(ctx, _d_eidx, d_w, _d_pos, _d_keep, d_probs, _d_counts):
        probs, eidx, keep = ctx.saved_tensors
        if d_w is None:
            d_w = torch.zeros(eidx.shape, dtype=torch.float32, device=probs.device)
        d_logits = gating_backward(probs, eidx, keep, d_w, d_probs, normalize=ctx.normalize)
        return d_logits, None, None, None, None


def gating_backward_plain(probs, expert_idx, keep, d_w, d_probs=None, *,
                          normalize: bool = True) -> torch.Tensor:
    """Kernel 1b's function in PyTorch: d logits [T, E] f32 from the
    gradients of ``combine_w`` (d_w [T, K]) and of ``probs`` (d_probs [T,
    E], or None), as ``jax.value_and_grad`` takes them through
    ``top_k_gating``: dg = keep * d_w; with ``normalize`` and K > 1, dp[idx_k]
    += (dg_k - sum_j dg_j g_j) / s (s = sum_k p[idx_k], g = p[idx] / s),
    else += dg_k; then the softmax's backward, p * (dp - sum(p * dp))."""
    idx = expert_idx.long()
    dg = torch.where(keep, d_w.float(), torch.zeros((), device=probs.device))
    if normalize and idx.shape[1] > 1:
        pk = probs.gather(1, idx)
        s = pk.sum(-1, keepdim=True)
        add = (dg - (dg * (pk / s)).sum(-1, keepdim=True)) / s
    else:
        add = dg
    dp = (d_probs.float().clone() if d_probs is not None else torch.zeros_like(probs))
    dp.scatter_add_(1, idx, add)
    return probs * (dp - (probs * dp).sum(-1, keepdim=True))


def gating_backward(probs, expert_idx, keep, d_w, d_probs=None, *,
                    normalize: bool = True) -> torch.Tensor:
    """d logits [T, E] f32: kernel 1b on the card (one warp per token), the
    plain version on the CPU."""
    if probs.device.type == "cpu":
        return gating_backward_plain(probs, expert_idx, keep, d_w, d_probs, normalize=normalize)
    if probs.device.type != "cuda":
        raise ValueError(f"moe_gating_backward: no kernel for device {probs.device}")
    name = "moe_gating_backward"
    T, E = probs.shape
    K = expert_idx.shape[1]
    if probs.dtype != torch.float32 or not probs.is_contiguous():
        raise TypeError(f"{name}: probs must be a contiguous [T, E] float32 tensor")
    if expert_idx.dtype != torch.int32 or keep.dtype != torch.bool or expert_idx.shape != (T, K):
        raise TypeError(f"{name}: expert_idx must be [T, K] int32 and keep [T, K] bool")
    if not (1 <= K <= min(E, MAX_TOP_K)) or E > MAX_EXPERTS:
        raise ValueError(f"{name}: the kernel takes E <= {MAX_EXPERTS} and 1 <= K <= min(E, "
                         f"{MAX_TOP_K}); got E={E}, K={K}")
    d_w = d_w.float().contiguous()
    if d_probs is not None:
        d_probs = d_probs.float().contiguous()
    eidx, kp = expert_idx.contiguous(), keep.contiguous()
    out = torch.empty((T, E), dtype=torch.float32, device=probs.device)
    lib = _library()
    with torch.cuda.device(probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_gating_backward_f32(
            probs.data_ptr(), eidx.data_ptr(), kp.data_ptr(), d_w.data_ptr(),
            d_probs.data_ptr() if d_probs is not None else None, out.data_ptr(), T, E, K,
            int(normalize), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1
    return out


def _gating(logits: torch.Tensor, top_k: int, capacity: int, normalize: bool,
            one_launch: bool) -> Tuple[Gating, torch.Tensor]:
    """``gating`` on the path ``one_launch`` names, whatever the slot count
    (the quick loop ``launch/expert_kernels.py`` measures both paths)."""
    if logits.device.type == "cpu":
        return gating_plain(logits, top_k, capacity, normalize=normalize)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: no kernel for device {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32 or not logits.is_contiguous():
        raise TypeError(f"moe_gating: logits must be a contiguous [T, E] float32 tensor, got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    T, E = logits.shape
    if not (1 <= top_k <= min(E, MAX_TOP_K)) or E > MAX_EXPERTS or capacity < 1 or T < 1:
        raise ValueError(f"moe_gating: the kernel takes E <= {MAX_EXPERTS}, 1 <= top_k <= "
                         f"min(E, {MAX_TOP_K}), capacity >= 1; got T={T}, E={E}, top_k={top_k}, "
                         f"capacity={capacity}")
    dev = logits.device
    TE, TK = T * E, T * top_k
    # one allocation of 4-byte words carved into the six outputs: probs,
    # eidx, w, pos, counts, then keep's bytes
    buf = torch.empty(TE + 3 * TK + E + (TK + 3) // 4, dtype=torch.int32, device=dev)
    f32 = buf.view(torch.float32)
    probs = f32.as_strided((T, E), (E, 1), 0)
    eidx = buf.as_strided((T, top_k), (top_k, 1), TE)
    w = f32.as_strided((T, top_k), (top_k, 1), TE + TK)
    pos = buf.as_strided((T, top_k), (top_k, 1), TE + 2 * TK)
    counts = buf.as_strided((E,), (1,), TE + 3 * TK)
    keep = buf.view(torch.bool).as_strided((T, top_k), (top_k, 1), 4 * (TE + 3 * TK + E))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_gating_f32(logits.data_ptr(), probs.data_ptr(), eidx.data_ptr(), w.data_ptr(),
                                 pos.data_ptr(), keep.data_ptr(), counts.data_ptr(), T, E, top_k,
                                 capacity, int(normalize), int(one_launch), stream)
    if err != 0:
        raise RuntimeError(f"moe_gating: kernel launch failed with CUDA error {err}")
    launches["moe_gating"] += 1
    variant_launches["moe_gating_one_launch" if one_launch else "moe_gating_two_launches"] += 1
    return Gating(eidx, w, pos, keep, probs), counts
