"""Mamba-2 SSD (state-space duality) mixer (``repro/models/ssm.py``)
[arXiv:2405.21060].

Prefill and training run the chunked SSD algorithm (quadratic within a chunk
of ``spec.chunk`` tokens, linear across chunks); decode is the one-token
recurrence on the f32 ``[B, H, P, N]`` state.  ``ssd_reference`` is the
sequential oracle.  No TPU kernel computes any of it: every product here is
a PyTorch operator.

Launches do not grow with the tokens of a prefill: everything within a
chunk is batched over all chunks, and the inter-chunk state pass (JAX's
``lax.scan`` over chunks) is a Python loop of two element-wise launches per
chunk.  Caches (``state`` f32, ``conv`` the last ``conv_dim - 1`` inputs of
the depthwise conv, ``pos``) are written in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMSpec
from repro_torch.models.modules import dense_init
from repro_torch.quant.qarrays import materialize

# leaves kept in f32 whatever the parameter type (the JAX package's own)
F32_LEAVES = ("dt_bias", "A_log", "D")

RESUME_MODES = ("prefill_chunk", "prefill_chunk_batched")


# ---------------------------------------------------------------------------
# Params and caches
# ---------------------------------------------------------------------------


def _normal(gen, shape, std: float, dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.is_meta:
        return out.to(dtype)
    return torch.nn.init.normal_(out, 0.0, std, generator=gen).to(dtype)


def init_ssm(gen, cfg: ModelConfig, spec: SSMSpec, dtype, device, *, lead=()) -> dict:
    d = cfg.d_model
    di, g, n, h = spec.d_inner, spec.n_groups, spec.state_dim, spec.num_heads
    lead = tuple(lead)
    in_dim = 2 * di + 2 * g * n + h  # z, x, B, C, dt
    conv_ch = di + 2 * g * n

    def f32(values):
        return values.to(device).expand(lead + values.shape).contiguous()

    return {
        "in_proj": dense_init(gen, d, in_dim, dtype, device, lead=lead),
        "conv_w": _normal(gen, lead + (spec.conv_dim, conv_ch), 0.1, dtype, device),
        "dt_bias": f32(torch.zeros(h)),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, h))),
        "D": f32(torch.ones(h)),
        "out_proj": dense_init(gen, di, d, dtype, device, lead=lead),
        "norm_scale": torch.zeros(lead + (di,), dtype=dtype, device=device),  # gated RMSNorm
    }


def init_ssm_cache(batch: int, spec: SSMSpec, dtype, device, *, lead=()) -> dict:
    lead = tuple(lead)
    conv_ch = spec.d_inner + 2 * spec.n_groups * spec.state_dim
    return {
        "state": torch.zeros(lead + (batch, spec.num_heads, spec.head_dim, spec.state_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, spec.conv_dim - 1, conv_ch), dtype=dtype, device=device),
        # kept for parity with the JAX cache (unused numerically)
        "pos": torch.zeros(lead + (batch, 1), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prefix: Optional[torch.Tensor] = None,
                 valid_len: Optional[torch.Tensor] = None):
    """Depthwise causal conv: x [B, L, C], w [K, C], prefix [B, K-1, C] (the
    inputs before x; zeros when None).  Returns (out [B, L, C], the new
    prefix).  ``valid_len`` [B] (a batched chunk: each row a valid prefix of
    n_i inputs, then padding): the new prefix is the K-1 inputs ending at
    the last valid one, ``xp[n_i : n_i + K-1]``; n_i = 0 returns the incoming
    prefix.  Outputs at valid positions never see padding (the conv is
    causal and padding comes last)."""
    K = w.shape[0]
    L = x.shape[1]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)  # [B, L+K-1, C]
    out = 0
    for i in range(K):  # JAX's sum: ((0 + t0) + t1) + ...
        out = out + xp[:, i : i + L] * w[i]
    if valid_len is None:
        new_prefix = xp[:, xp.shape[1] - (K - 1):]
    else:
        idx = valid_len.long()[:, None] + torch.arange(K - 1, device=x.device)
        new_prefix = xp.gather(1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    return out, new_prefix


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., L] -> [..., L, L]: S[i, j] = sum(a[j+1 .. i]) for j <= i (0 on
    the diagonal), -inf above."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full((), -torch.inf, device=a.device))


def _heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Groups -> heads: each group repeated ``rep`` times along ``dim``."""
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=dim)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bmat, Cmat, chunk: int, init_state=None):
    """x [B, L, H, P], dt [B, L, H] (after softplus), A [H] (negative),
    Bmat / Cmat [B, L, G, N] -> (y [B, L, H, P], final state [B, H, P, N])."""
    Bsz, L0, H, Pdim = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    Q = min(chunk, L0)
    # pad L to a multiple of the chunk: dt = 0 there is exact (decay 1, input 0)
    pad = (-L0) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
    L = L0 + pad
    nc = L // Q
    rep = H // G

    def toc(t):  # [B, L, ...] -> [B, nc, Q, ...]
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    xc = toc(x * dt[..., None])  # x pre-scaled by dt (the standard SSD form)
    dA = toc(dt * A[None, None, :])  # [B, nc, Q, H]
    Bh = _heads(toc(Bmat), rep, 3)  # [B, nc, Q, H, N]
    Ch = _heads(toc(Cmat), rep, 3)
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA.movedim(3, 2)))  # [B, nc, H, Q, Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    M = scores * Lmat.to(scores.dtype)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xc)

    # chunk states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [B, nc, Q, H]
    states = torch.einsum("bcqhn,bcqhp->bchpn", Bh * decay_to_end[..., None], xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # [B, nc, H]
    h = (init_state.to(states.dtype) if init_state is not None
         else torch.zeros((Bsz, H, Pdim, N), dtype=states.dtype, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # [B, nc, H, P, N]

    # inter-chunk contribution
    state_decay = torch.exp(dA_cs)  # from the chunk start to position q
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch, prev_states) * state_decay[..., None]
    y = (y_diag + y_off).reshape(Bsz, L, H, Pdim)
    return y[:, :L0], h


def ssd_reference(x, dt, A, Bmat, Cmat, init_state=None):
    """The sequential recurrence (tests, and the one-token decode step)."""
    Bsz, L, H, Pdim = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    Bh = _heads(Bmat, rep, 2)
    Ch = _heads(Cmat, rep, 2)
    h = (init_state if init_state is not None
         else torch.zeros((Bsz, H, Pdim, N), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A[None, :])  # [B, H]
        h = h * decay[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Layer apply
# ---------------------------------------------------------------------------


def ssm_layer(
    cfg: ModelConfig,
    spec: SSMSpec,
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (y, cache), the cache updated in place.  Decode and chunked
    prefill resume from the cache's state and conv prefix; a batched chunk
    (``prefill_chunk_batched``, positions [B, S] with -1 at padding) steps
    with dt = 0 on padding (the identity) and takes each row's conv prefix at
    its last valid input."""
    B, S, _ = x.shape
    di, g, n, h, p = spec.d_inner, spec.n_groups, spec.state_dim, spec.num_heads, spec.head_dim

    proj = x @ materialize(params["in_proj"])  # [B, S, 2di + 2gn + h]
    z, xin, Bm, Cm, dt = torch.split(proj, [di, di, g * n, g * n, h], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    resume = cache is not None and (mode.startswith("decode") or mode in RESUME_MODES)
    batched = mode == "prefill_chunk_batched" and positions is not None
    valid = positions >= 0 if batched else None  # [B, S]
    valid_len = valid.sum(dim=1) if batched else None
    prefix = cache["conv"] if resume else None
    conv_out, new_prefix = _causal_conv(conv_in, materialize(params["conv_w"]), prefix, valid_len)
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, g * n, g * n], dim=-1)

    xh = xin.reshape(B, S, h, p)
    Bh = Bm.reshape(B, S, g, n).float()
    Ch = Cm.reshape(B, S, g, n).float()
    dtf = dt.float() + params["dt_bias"]
    dtf = torch.logaddexp(dtf, torch.zeros((), dtype=dtf.dtype, device=dtf.device))  # softplus
    if batched:
        dtf = torch.where(valid[:, :, None], dtf, 0.0)  # the identity step on padding
    A = -torch.exp(params["A_log"])  # [h], negative

    init_state = cache["state"] if resume else None
    if mode.startswith("decode") and S == 1:
        y, state = ssd_reference(xh.float(), dtf, A, Bh, Ch, init_state)
    else:
        y, state = ssd_chunked(xh.float(), dtf, A, Bh, Ch, spec.chunk, init_state)

    y = y + xh.float() * params["D"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)

    # gated RMSNorm (mamba2)
    y32 = y.float() * F.silu(z.float())
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.rms_eps) * (1.0 + params["norm_scale"].float())).to(x.dtype)
    out = y @ materialize(params["out_proj"])

    if cache is not None:
        cache["state"].copy_(state)
        cache["conv"].copy_(new_prefix)
        cache["pos"].add_(S)
    return out, cache
