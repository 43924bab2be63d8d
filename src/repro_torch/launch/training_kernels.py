"""Per-row checks and CUDA-graph timings of the training kernels on the
card: kernel 6b (flash attention backward), kernel 1b (capacity gating
backward) and kernels 2b / 4b (the SwiGLU expert MLP's backward over the
capacity and the grouped buffer), each held against its plain version on
the same inputs, and kernel 6's forward with and without its row
log-sum-exp output.

Kernel 6b at the training shapes of the port's configs (``FLASH_BWD_CASES``:
nlg-350m-prmoe-32-64's 8 x 512 tokens, 16 heads over 16 at dh 64, causal;
G = 4 at dh 128; a window; a softcap; non-causal as seamless's encoder;
dh 256, 32 and 112 small), in bf16 and f32: the forward's L against the
plain forward's, then dq, dk and dv per row against
``flash_attention_backward_plain`` given the same out, L and dO (a row's
error against the larger of its largest value and ``ROW_FLOOR`` of the
tensor's: ``grad_rows``), and a second launch on the same inputs bit for
bit against the first (``deterministic``), with each pass's block count
beside the SM count (``blocks``: bf16 on the tensor cores, whose dK / dV
pass splits a kv-head's heads across blocks on small grids); timed
beside its bound (10 dh operations per valid (head, pair), or the bytes of
q, k, v, O, dO, dQ, dK and dV) and beside the backward of
``scaled_dot_product_attention`` (graph time of its forward and backward
less its forward's; never called by the port).  Kernel 1b at T = 4096 over
E = 32 and 64 (top-1, capacity factor 1.25) and top-2 normalised with
drops, beside its bound (bytes); no single PyTorch call computes it; and,
in the same call and with the same graph timing, the floor of one launch:
kernel 1b at T = 1 (one warp) and the smallest PyTorch kernel, a ``zero_()``
of one f32 element (``launch_floor``), with 1b at T = 4096 over each.

Kernels 2b and 4b at ``EXPERT_BWD_CASES`` (llama4-maverick's width, D 5120
and F 8192 over 16 experts top-1 at T = 2048, the capacity buffer at C =
160 and the grouped one; kimi-k2's, D 7168 and F 2048 over 32 experts
top-8 at T = 1024; a capacity buffer with an expert no token reaches and
experts past their capacity; a grouped buffer whose dead tiles hold
garbage; D and F odd multiples of 128), in bf16 (the wgmma passes,
``variant``) and f32: dx, dwi, dwg and dwo per row against
``expert_mlp_backward_plain`` / ``grouped_mlp_backward_plain``
(``grad_rows``), dead rows of dx and empty experts' gradients exactly 0,
a second launch bit for bit against the first; timed from CUDA graphs
beside the bound (16 live rows D F operations; the live experts' weights
read, every gradient and dx written, x and dy of the live rows read), the
plain version's host-clock time, each pass's device ms from
torch.profiler (``passes_ms``) and the same gradients through eight
``torch.bmm`` (cuBLAS) and the SwiGLU's elementwise backward over the
buffer padded to [E, R, D]: a composite, not one call (``composite_ms``).

  PYTHONPATH=src python -m repro_torch.launch.training_kernels [--quick]
      [--only flash,gating,expert] [--variants]

``--variants`` also times 2b / 4b's patched builds (``EXPERT_VARIANTS``: no
weight tiles loaded by TMA in passes A and B, no loads or no stores in pass
C) in turns at llama4's capacity case: what bounds each pass, without a
profiler's stall reasons.

``--quick`` runs each case at its smallest size, untimed: the first call of
a changed kernel.  It builds only the sources involved.  Prints one
line per case; exits non-zero if a case disagrees or is not deterministic.
To hold a change against its parent on one card, unpack the parent with
``git archive HEAD | tar -x -C build/parent`` and run both in one call, in
turns: ``PYTHONPATH=build/parent/src python3
src/repro_torch/launch/training_kernels.py`` (parent), then this module.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.kernels.attention_paged import _sm_count
from repro_torch.launch.paged_kernels import BF16_TOL, F32_TOL, graph_ms, rows

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# f32 backward: sums of S * G terms in other orders, and L from the
# forward's own order: a few ulps of each row's largest; bf16: the gradients
# are rounded to bf16 once (2^-8), and P is rounded to bf16 for dV in both
# versions from exponentials that may differ in the last bit
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: BF16_TOL}
LSE_TOL = 1e-5  # |L - L_plain|, absolute: logs of f32 sums of at most 4096 terms

# name -> (B, S, H, Hkv, dh, causal, window, softcap); T = S
FLASH_BWD_CASES = {
    "nlg_train_8x512": (8, 512, 16, 16, 64, True, 0, 0.0),
    "g4_dh128": (2, 1024, 32, 8, 128, True, 0, 0.0),
    "window": (2, 1024, 8, 8, 128, True, 256, 0.0),
    "softcap": (2, 512, 8, 4, 64, True, 0, 30.0),
    "noncausal_4x1024": (4, 1024, 16, 16, 64, False, 0, 0.0),
    "dh256": (1, 512, 4, 1, 256, True, 0, 0.0),
    "dh32": (2, 256, 4, 2, 32, True, 0, 0.0),
    "dh112": (2, 256, 4, 4, 112, True, 0, 0.0),
    "llama4_g5_4x512": (4, 512, 40, 8, 128, True, 0, 0.0),
}
# name -> (T, E, K, capacity factor, bias to expert 0: drops)
GATING_BWD_CASES = {
    "T4096_E32_K1": (4096, 32, 1, 1.25, 0.0),
    "T4096_E64_K1": (4096, 64, 1, 1.25, 0.0),
    "T4096_E64_K2_drops": (4096, 64, 2, 0.5, 1.0),
}

# name -> (layout, E, D, F, top-k, T, capacity factor, bias: "empty" routes
# no token to expert 1 and most to expert 0 (drops), "garbage" fills the
# grouped buffer's dead tiles with random rows)
EXPERT_BWD_CASES = {
    "llama4_capacity": ("capacity", 16, 5120, 8192, 1, 2048, 1.25, None),
    "llama4_grouped": ("grouped", 16, 5120, 8192, 1, 2048, 0.0, None),
    "kimi_capacity": ("capacity", 32, 7168, 2048, 8, 1024, 1.25, None),
    "kimi_grouped": ("grouped", 32, 7168, 2048, 8, 1024, 0.0, None),
    "capacity_empty_expert": ("capacity", 16, 1024, 2048, 2, 512, 1.0, "empty"),
    "grouped_dead_tiles": ("grouped", 16, 1024, 2048, 2, 200, 0.0, "garbage"),
    # D and F odd multiples of 128: pass C's last 256-column dWo tile is cut
    # at the edge
    "grouped_ragged": ("grouped", 8, 384, 640, 2, 100, 0.0, "garbage"),
}


# a gradient row's error is judged against the larger of its own largest
# value and this share of the tensor's largest: a row whose true gradient
# vanishes (the first causal query, whose softmax over one key has none)
# holds only the rounding of a cancellation of terms at the tensor's scale
ROW_FLOOR = 1e-2


def grad_rows(out, ref, floor=ROW_FLOOR) -> dict:
    """``rows`` for a gradient: per row, max|out - ref| over max(the row's
    max|ref|, ``floor`` x the tensor's max|ref|)."""
    o, p = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    if not (torch.isfinite(o).all() and torch.isfinite(p).all()):
        return {"finite": False}
    top = p.abs().max().item()
    row = p.abs().amax(-1)
    rel = (o - p).abs().amax(-1) / row.clamp_min(max(floor * top, 1e-30))
    return {"max_rel_err": (o - p).abs().max().item() / max(top, 1e-30),
            "max_row_rel_err": rel.max().item(), "median_row_rel_err": rel.median().item(),
            "rows_below_floor": int((row < floor * top).sum())}


def bound(need_bytes, ops, dtype) -> dict:
    b, o = need_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return {"bound_ms": max(b, o) * 1e3, "bound_by": "bytes" if b >= o else "operations",
            "bytes": need_bytes, "ops": ops}


def valid_pairs(q_pos, k_pos, causal, window) -> int:
    """(query, key) pairs the masks leave, over the batch rows (per head)."""
    n = 0
    for b in range(q_pos.shape[0]):
        kp = k_pos[b][None, :].long()
        for s0 in range(0, q_pos.shape[1], 1024):
            qp = q_pos[b, s0 : s0 + 1024][:, None].long()
            ok = kp >= 0
            if causal:
                ok = ok & (kp <= qp)
            if window > 0:
                ok = ok & (qp - kp < window)
            n += int(ok.sum().item())
    return n


def flash_bwd_inputs(gen, B, S, H, Hkv, dh, dtype, empty_key=False):
    """q, k, v, dout and positions 0 .. S - 1 (one key of row 0 emptied with
    ``empty_key``), on the card."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S).contiguous()
    k_pos = pos.clone()
    if empty_key:
        k_pos[0, 1] = -1
    return rnd(B, S, H, dh), rnd(B, S, Hkv, dh), rnd(B, S, Hkv, dh), rnd(B, S, H, dh), pos, k_pos


def sdpa_backward_ms(q, k, v, dout, scale, causal, window) -> float:
    """Device time of the backward of scaled_dot_product_attention over
    [B, heads, tokens, dh] copies: graph time of forward and backward less
    the forward's (the yardstick, never the port's path)."""
    import torch.nn.functional as F

    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    doh = dout.transpose(1, 2).contiguous()
    mask = None
    if window > 0:
        S = q.shape[1]
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    kw = dict(scale=scale, enable_gqa=True, attn_mask=mask, is_causal=causal and mask is None)
    fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qh, kh, vh), doh)

    return graph_ms(fwd_bwd, n=5) - graph_ms(fwd, n=5)


def check_flash_bwd(name, B, S, H, Hkv, dh, causal, window, softcap, dtype, gen, timed=True,
                    empty_key=False) -> dict:
    """Kernel 6's L and kernel 6b's dq / dk / dv against the plain versions
    (per row: a query of a head for dq, a key of a kv-head for dk / dv)."""
    from repro_torch.kernels import flash_attention as k6

    q, k, v, dout, q_pos, k_pos = flash_bwd_inputs(gen, B, S, H, Hkv, dh, dtype, empty_key)
    scale = dh ** -0.5
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    out, lse = k6._forward(q, k, v, q_pos, k_pos, return_lse=True, **kw)
    out_ref, lse_ref = k6.flash_attention_plain(q, k, v, q_pos, k_pos, return_lse=True, **kw)
    torch.cuda.synchronize()
    finite = torch.isfinite(lse_ref)
    res = {"shape": [B, S, H, Hkv, dh], "dtype": str(dtype).split(".")[-1], "causal": causal,
           "window": window, "softcap": softcap,
           "lse_max_abs_err": (lse - lse_ref)[finite].abs().max().item(),
           "lse_inf_agree": bool(torch.equal(torch.isinf(lse), ~finite)),
           "out": rows(out, out_ref)}
    args = (q, k, v, q_pos, k_pos, out, dout, lse)
    grads = k6.flash_attention_backward(*args, **kw)
    again = k6.flash_attention_backward(*args, **kw)
    torch.cuda.synchronize()
    refs = k6.flash_attention_backward_plain(*args, **kw)
    tol = BWD_TOL[dtype]
    # two launches on the same inputs: bit for bit (no atomics in any sum)
    res["deterministic"] = all(torch.equal(a, b) for a, b in zip(grads, again))
    res["blocks"] = k6.backward_blocks(B, S, S, H, Hkv, dh, dtype, _sm_count(q.device.index))
    ok = res["lse_max_abs_err"] <= LSE_TOL and res["lse_inf_agree"] and res["deterministic"]
    for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
        res[gname] = grad_rows(g, r)
        ok &= res[gname].get("finite", True) and res[gname]["max_row_rel_err"] <= tol
    res["max_abs_err"] = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs))
    res["ok"] = bool(ok)
    if timed:
        pairs = valid_pairs(q_pos, k_pos, causal, window)
        e = q.element_size()
        need = e * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel() + 4 * (q_pos.numel() + k_pos.numel())
        res.update(bound(need, 10 * dh * pairs * H, dtype), pairs_per_head=pairs)
        res["ms"] = graph_ms(lambda: k6.flash_attention_backward(*args, **kw))
        res["plain_ms"] = graph_ms(lambda: k6.flash_attention_backward_plain(*args, **kw), n=2, reps=3)
        res["fwd_ms"] = graph_ms(lambda: k6._forward(q, k, v, q_pos, k_pos, **kw))
        res["fwd_lse_ms"] = graph_ms(lambda: k6._forward(q, k, v, q_pos, k_pos, return_lse=True, **kw))
        res["library_ms"] = (None if softcap > 0 else
                             sdpa_backward_ms(q, k, v, dout, scale, causal, window))
    return res


def check_gating_bwd(name, T, E, K, cf, bias, gen, timed=True) -> dict:
    """Kernel 1b against its plain version, per token row, on the gating
    kernel's own outputs for random logits, random gate-weight gradients and
    the aux loss's probability gradient (E f_e / T per column, times a
    random factor per row so no two rows share it)."""
    from repro_torch.core.gating import count_ids, expert_capacity
    from repro_torch.kernels import moe_gating as k1

    logits = torch.randn((T, E), generator=gen, device="cuda")
    logits[:, 0] += bias
    cap = expert_capacity(T, E, K, cf)
    g, _ = k1.gating(logits, K, cap)
    d_w = torch.randn((T, K), generator=gen, device="cuda")
    f = count_ids(g.expert_idx[:, 0], E).float() / T
    d_probs = (E * f / T)[None, :] * torch.rand((T, 1), generator=gen, device="cuda")
    args = (g.probs, g.expert_idx, g.keep, d_w, d_probs)
    out = k1.gating_backward(*args)
    torch.cuda.synchronize()
    ref = k1.gating_backward_plain(*args)
    res = {"shape": [T, E, K], "capacity": cap, "dropped": int((~g.keep).sum().item()),
           **rows(out, ref), "max_abs_err": (out - ref).abs().max().item()}
    res["ok"] = bool(res.get("finite", True) and res["max_row_rel_err"] <= F32_TOL)
    if timed:
        need = 3 * 4 * T * E + 9 * T * K
        res.update(bound(need, 0, torch.float32))
        res["ms"] = graph_ms(lambda: k1.gating_backward(*args))
        res["plain_ms"] = graph_ms(lambda: k1.gating_backward_plain(*args))
        res["library_ms"] = None
    return res


def launch_floor(gen, gating_ms: dict) -> dict:
    """What one graph-replayed launch costs on this card: kernel 1b over one
    token (one warp) and a ``zero_()`` of one f32 element, beside each
    T = 4096 case of 1b (``gating_ms``: case -> ms) as a ratio to the
    one-warp launch."""
    from repro_torch.kernels import moe_gating as k1

    logits = torch.randn((1, 32), generator=gen, device="cuda")
    g, _ = k1.gating(logits, 1, 8)
    args = (g.probs, g.expert_idx, g.keep, torch.randn((1, 1), generator=gen, device="cuda"),
            torch.rand((1, 32), generator=gen, device="cuda"))
    one = torch.zeros(1, device="cuda")
    res = {"moe_gating_backward_T1_E32_K1_ms": graph_ms(lambda: k1.gating_backward(*args)),
           "zero_one_f32_ms": graph_ms(one.zero_)}
    res["T4096_over_one_warp"] = {name: ms / res["moe_gating_backward_T1_E32_K1_ms"]
                                  for name, ms in gating_ms.items()}
    return res


def expert_bwd_inputs(layout, E, D, F, K, T, cf, bias, dtype, gen) -> dict:
    """A backward call's inputs as the MoE layer builds them, on the card:
    random weights (scaled by 1 / sqrt(fan-in)), T random tokens routed by a
    random router (``bias``: see ``EXPERT_BWD_CASES``) and dispatched into
    the capacity buffer (fill: the gating's uncapped counts) or the grouped
    one; dy random on every row, dead rows included (the kernel must ignore
    them)."""
    from repro_torch.core import dispatch, dispatch_grouped
    from repro_torch.core.gating import expert_capacity, top_k_gating

    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    w = {"wi": rnd(E, D, F).mul_(D ** -0.5), "wg": rnd(E, D, F).mul_(D ** -0.5),
         "wo": rnd(E, F, D).mul_(F ** -0.5)}
    x = rnd(T, D)
    logits = torch.randn((T, E), generator=gen, device="cuda")
    if bias == "empty":
        logits[:, 1] = -1e9
        logits[:, 0] += 2.0
    if layout == "capacity":
        cap = expert_capacity(T, E, K, cf)
        g = top_k_gating(logits, K, cap)
        counts = torch.bincount(g.expert_idx.reshape(-1).long(), minlength=E).to(torch.int32)
        xb = dispatch.dispatch_dense(x, g, cap, E)
        live = counts.clamp(max=cap)
        info = {"C": cap, "kept": int(live.sum()), "dropped": T * K - int(live.sum()),
                "fill_max": int(counts.max())}
        key = {"fill": counts}
    else:
        g = top_k_gating(logits, K, T * K)
        lay = dispatch_grouped.grouped_layout(g, E)
        Ct = lay.tile_expert.shape[0] * 8
        xb = torch.zeros((Ct, D), dtype=dtype, device="cuda")
        xb[lay.dst] = x[torch.arange(T * K, device="cuda") // K]
        used = int(lay.rows_used)
        if bias == "garbage":
            xb[used:] = rnd(Ct - used, D)
        live = lay.counts
        info = {"tiles": Ct // 8, "live_tiles": used // 8, "kept": T * K}
        key = {"te": lay.tile_expert, "rows_used": lay.rows_used}
    info.update(layout=layout, E=E, D=D, F=F, K=K, T=T, live_experts=int((live > 0).sum()))
    dy = rnd(*xb.shape)
    return {"x": xb, "dy": dy, **w, **key, "info": info, "live": live.cpu()}


def expert_bwd_calls(inp):
    """(kernel call, plain call) of the case's layout."""
    from repro_torch.kernels import expert_mlp as k2
    from repro_torch.kernels import expert_mlp_grouped as gk

    a = (inp["x"], inp["wi"], inp["wg"], inp["wo"], inp["dy"])
    if "fill" in inp:
        return (lambda: k2.expert_mlp_backward(*a, inp["fill"]),
                lambda: k2.expert_mlp_backward_plain(*a, inp["fill"]))
    x, wi, wg, wo, dy = a
    return (lambda: gk.grouped_mlp_backward(x, inp["te"], wi, wg, wo, dy, inp["rows_used"]),
            lambda: gk.grouped_mlp_backward_plain(x, inp["te"], wi, wg, wo, dy, inp["rows_used"]))


def dead_rows(inp) -> torch.Tensor:
    """[rows] bool: the buffer's rows that hold no token."""
    if "fill" in inp:
        E, C, _ = inp["x"].shape
        return (torch.arange(C, device="cuda")[None, :] >= inp["fill"].clamp(0, C)[:, None]).reshape(-1)
    rows = inp["x"].shape[0]
    return torch.arange(rows, device="cuda") >= inp["rows_used"]


def composite_backward(inp):
    """The same gradients through cuBLAS: the buffer's rows padded per
    expert to [E, R, D] (the capacity buffer as it is; the grouped one
    packed by its tile map, outside the timed call), eight ``torch.bmm``
    and the SwiGLU's elementwise backward in f32.  Returns the timed
    callable (a yardstick: not one call, never the port's path)."""
    x, dy, wi, wg, wo = inp["x"], inp["dy"], inp["wi"], inp["wg"], inp["wo"]
    E, D = wi.shape[0], wi.shape[1]
    if x.dim() == 2:  # grouped: pack each expert's live rows
        used = int(inp["rows_used"])
        te = inp["te"].long().repeat_interleave(8)[:used]
        R = max(1, int(torch.bincount(te, minlength=E).max()))
        xs = torch.zeros((E, R, D), dtype=x.dtype, device="cuda")
        ds = torch.zeros_like(xs)
        for e in range(E):
            rows = torch.nonzero(te == e).flatten()
            xs[e, :rows.numel()] = x[rows]
            ds[e, :rows.numel()] = dy[rows]
        x, dy = xs, ds
    dt = x.dtype

    def run():
        u, g = torch.bmm(x, wi).float(), torch.bmm(x, wg).float()
        da = torch.bmm(dy, wo.transpose(1, 2)).float()
        s = torch.sigmoid(g)
        silu = g * s
        a, du = (silu * u).to(dt), (da * silu).to(dt)
        dg = (da * u * s * (1 + g * (1 - s))).to(dt)
        dx = torch.baddbmm(torch.bmm(du, wi.transpose(1, 2)), dg, wg.transpose(1, 2))
        xt = x.transpose(1, 2)
        return dx, torch.bmm(xt, du), torch.bmm(xt, dg), torch.bmm(a.transpose(1, 2), dy)

    return run


EXPERT_BWD_PASSES = ("prep_kernel", "Memset", "pack_kernel", "pass_a", "pass_b", "pass_c")


def passes_ms(fn, names=EXPERT_BWD_PASSES) -> dict:
    """Device ms of one call of ``fn`` by pass: torch.profiler's CUDA
    records of a call after a warm-up one, summed per name in ``names``
    that a kernel's name contains (``pass_c`` sums its two instances);
    empty where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.key:
                out[n] = out.get(n, 0.0) + ev.self_device_time_total / 1e3
    return out


def check_expert_bwd(name, layout, E, D, F, K, T, cf, bias, dtype, gen, timed=True) -> dict:
    """Kernel 2b (capacity) or 4b (grouped) against its plain version per
    row of each gradient (a token row of dx, a row of each weight
    gradient), dead rows and empty experts exactly 0, bit for bit over two
    launches; timed beside the bound, the plain version and the cuBLAS
    composite."""
    from repro_torch.kernels import expert_mlp_grouped as gk

    inp = expert_bwd_inputs(layout, E, D, F, K, T, cf, bias, dtype, gen)
    kernel, plain = expert_bwd_calls(inp)
    before = dict(gk.variant_launches)
    grads = kernel()
    again = kernel()
    torch.cuda.synchronize()
    took = sorted({k.rsplit("_", 1)[1] for k, v in gk.variant_launches.items() if v != before[k]})
    t0 = time.perf_counter()
    refs = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    res = {**inp["info"], "dtype": str(dtype).split(".")[-1], "variant": took}
    res["deterministic"] = all(torch.equal(a, b) for a, b in zip(grads, again))
    dead = dead_rows(inp)
    empty = (inp["live"] == 0).nonzero().flatten().tolist()
    res["dead_rows"], res["empty_experts"] = int(dead.sum()), empty
    res["zeros_exact"] = bool(grads[0].reshape(-1, D)[dead].count_nonzero() == 0 and all(
        g[e].count_nonzero() == 0 for g in grads[1:] for e in empty))
    tol = BWD_TOL[dtype]
    ok = res["deterministic"] and res["zeros_exact"] and took == [gk.backward_variant(dtype, D, F)]
    for gname, g, r in zip(("dx", "dwi", "dwg", "dwo"), grads, refs):
        res[gname] = grad_rows(g.reshape(-1, g.shape[-1]), r.reshape(-1, r.shape[-1]))
        ok &= res[gname].get("finite", True) and res[gname]["max_row_rel_err"] <= tol
    res["max_abs_err"] = max((g.float() - r.float()).abs().max().item() for g, r in zip(grads, refs))
    res["ok"] = bool(ok)
    del again, refs
    if timed:
        b = inp["x"].element_size()
        live_e, kept = res["live_experts"], res["kept"]
        need = (live_e * 3 * D * F * b + 3 * E * D * F * b + 2 * kept * D * b
                + inp["x"].numel() * b)
        res.update(bound(need, 16 * kept * D * F, dtype))
        few = dtype == torch.float32
        res["ms"] = graph_ms(kernel, n=2 if few else 10, reps=3 if few else 5)
        res["passes_ms"] = passes_ms(kernel)
        res["plain_ms"] = plain_ms
        comp = composite_backward(inp)
        res["composite_ms"] = graph_ms(comp, n=2 if few else 10, reps=3 if few else 5)
        res["library_ms"] = None
    del grads, inp
    torch.cuda.empty_cache()
    return res


# Patches for --variants: (anchor, replacement) pairs applied to a copy of
# csrc/grouped_mlp_bwd.cu; each anchor must be found.  A skipped TMA load
# leaves its shared-memory tile as it was, and its bytes leave the stage's
# expected count: the sums are garbage and the time is what the pass costs
# without those bytes.
_NO_WEIGHT_LOADS = [
    ("""        mbar_expect_tx(bar, 2 * busy * BOX + 3 * BK * BNA * 2);""",
     """        mbar_expect_tx(bar, 2 * busy * BOX);"""),
    ("""        tma_load_2d(&s.wi[r.st][0][0], &p.wi, bar, f0, e * p.D + k0);
        tma_load_2d(&s.wg[r.st][0][0], &p.wg, bar, f0, e * p.D + k0);
        tma_load_2d(&s.wo[r.st][0][0], &p.wo, bar, k0, e * p.F + f0);""", ""),
    ("""        mbar_expect_tx(bar, 2 * busy * BOX + 2 * BNB * BK * 2);""",
     """        mbar_expect_tx(bar, 2 * busy * BOX);"""),
    ("""        tma_load_2d(&s.wi[r.st][0][0], &p.wi, bar, k0, e * p.D + d0);
        tma_load_2d(&s.wg[r.st][0][0], &p.wg, bar, k0, e * p.D + d0);""", "")]
_NO_C_LOADS = [("""          mbar_expect_tx(bar, (2 + NB * BN / 64) * BOX);""",
                """          mbar_arrive(bar);
          continue;""")]
_NO_C_STORES = [("""            if (n0 + 64 * j < p.N)
              tma_store_2d(""", """            if (n0 + 64 * j < 0)
              tma_store_2d(""")]
EXPERT_VARIANTS = {"kernel": [], "no_weight_loads": _NO_WEIGHT_LOADS,
                   "no_c_loads": _NO_C_LOADS, "no_c_stores": _NO_C_STORES}


def expert_variants(case="llama4_capacity", gen=None):
    """Kernel 2b / 4b's patched builds (``EXPERT_VARIANTS``: the weight
    tiles of passes A and B not loaded; pass C's tiles not loaded, or its
    sums not stored) swapped in for the wrapper's library in turns (each
    variant twice, in opposite orders) on one bf16 case: graph ms and each
    pass's profiler ms.  Prints one line per run."""
    import ctypes
    import shutil
    import subprocess

    from repro_torch.kernels import build
    from repro_torch.kernels import expert_mlp_grouped as gk

    root = build.BUILD_DIR / "variants_expert_bwd"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build.CSRC, root / "csrc")
    src = (build.CSRC / "grouped_mlp_bwd.cu").read_text()
    procs = {}
    for name, patches in EXPERT_VARIANTS.items():
        text = src
        for anchor, repl in patches:
            if anchor not in text:
                raise RuntimeError(f"variant {name}: anchor not found in grouped_mlp_bwd.cu")
            text = text.replace(anchor, repl)
        (root / "csrc" / f"grouped_mlp_bwd_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(root / f"lib{name}.so"),
             str(root / "csrc" / f"grouped_mlp_bwd_{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
    libs = {name: ctypes.CDLL(str(root / f"lib{name}.so")) for name in procs}
    inp = expert_bwd_inputs(*EXPERT_BWD_CASES[case], torch.bfloat16, gen)
    kernel, _ = expert_bwd_calls(inp)
    loaded = build._loaded.get("grouped_mlp_bwd")
    try:
        for name in list(libs) + list(libs)[::-1]:
            build._loaded["grouped_mlp_bwd"] = libs[name]
            gk._bwd_bound = None
            res = {"ms": graph_ms(kernel, n=10), "passes_ms": passes_ms(kernel)}
            print(f"expert backward variant {name}: {case} bf16 {json.dumps(res)}", flush=True)
    finally:
        gk._bwd_bound = None
        if loaded is None:
            build._loaded.pop("grouped_mlp_bwd", None)
        else:
            build._loaded["grouped_mlp_bwd"] = loaded


def quick_expert(case):
    """An expert case at a small size: the same layout, top-k and bias, at
    widths the tensor-core passes take (D an odd multiple of 128: pass C's
    ragged last 256-column dWo tile)."""
    layout, E, D, F, K, T, cf, bias = case
    return (layout, min(E, 8), 384, 640, min(K, 4), 64, cf, bias)


def quick_shape(case):
    """A case at its smallest size: a few tiles, the same heads and masks."""
    B, S, H, Hkv, dh, causal, window, softcap = case
    return (1, min(S, 96), H, Hkv, dh, causal, min(window, 40), softcap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smallest sizes, untimed")
    ap.add_argument("--only", default="flash,gating,expert",
                    help="comma-separated kernels: flash (6b), gating (1b), expert (2b / 4b)")
    ap.add_argument("--variants", action="store_true",
                    help="also time 2b / 4b's patched builds (EXPERT_VARIANTS) in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("training_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    only = set(args.only.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    names = (["flash_attention", "flash_attention_bwd"] if "flash" in only else []) + \
        (["moe_gating"] if only & {"flash", "gating"} else []) + \
        (["grouped_mlp_bwd"] if "expert" in only else [])
    print("build:", json.dumps(build.build(names)), flush=True)
    for src in names:
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name, case in (FLASH_BWD_CASES if "flash" in only else {}).items():
        case = quick_shape(case) if args.quick else case
        for dtype in (torch.bfloat16, torch.float32):
            res = check_flash_bwd(name, *case, dtype, gen, timed=not args.quick,
                                  empty_key=name == "window")
            ok &= res["ok"]
            print(f"{'ok  ' if res['ok'] else 'FAIL'} flash_attention_backward {name} "
                  f"{json.dumps(res)}", flush=True)
    for name, case in (EXPERT_BWD_CASES if "expert" in only else {}).items():
        case = quick_expert(case) if args.quick else case
        for dtype in (torch.bfloat16, torch.float32):
            res = check_expert_bwd(name, *case, dtype, gen, timed=not args.quick)
            ok &= res["ok"]
            kname = "expert_mlp_backward" if case[0] == "capacity" else "grouped_mlp_backward"
            print(f"{'ok  ' if res['ok'] else 'FAIL'} {kname} {name} {json.dumps(res)}", flush=True)
    if args.variants and "expert" in only:
        expert_variants(gen=gen)
    gating_ms = {}
    for name, (T, E, K, cf, bias) in (GATING_BWD_CASES if "gating" in only else {}).items():
        res = check_gating_bwd(name, T if not args.quick else 256, E, K, cf, bias, gen,
                               timed=not args.quick)
        ok &= res["ok"]
        gating_ms[name] = res.get("ms")
        print(f"{'ok  ' if res['ok'] else 'FAIL'} moe_gating_backward {name} {json.dumps(res)}",
              flush=True)
    if not args.quick and "gating" in only:
        print(f"launch floor: {json.dumps(launch_floor(gen, gating_ms))}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
