"""Per-row checks and CUDA-graph timings of the training kernels on the
card: kernel 6b (flash attention backward) and kernel 1b (capacity gating
backward), each held against its plain version on the same inputs, and
kernel 6's forward with and without its row log-sum-exp output.

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

  PYTHONPATH=src python -m repro_torch.launch.training_kernels [--quick]

``--quick`` runs each case at its smallest size, untimed: the first call of
a changed kernel.  It builds only the three sources involved.  Prints one
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
}
# name -> (T, E, K, capacity factor, bias to expert 0: drops)
GATING_BWD_CASES = {
    "T4096_E32_K1": (4096, 32, 1, 1.25, 0.0),
    "T4096_E64_K1": (4096, 64, 1, 1.25, 0.0),
    "T4096_E64_K2_drops": (4096, 64, 2, 0.5, 1.0),
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


def quick_shape(case):
    """A case at its smallest size: a few tiles, the same heads and masks."""
    B, S, H, Hkv, dh, causal, window, softcap = case
    return (1, min(S, 96), H, Hkv, dh, causal, min(window, 40), softcap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smallest sizes, untimed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("training_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print("build:", json.dumps(build.build(["flash_attention", "flash_attention_bwd", "moe_gating"])),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name, case in FLASH_BWD_CASES.items():
        case = quick_shape(case) if args.quick else case
        for dtype in (torch.bfloat16, torch.float32):
            res = check_flash_bwd(name, *case, dtype, gen, timed=not args.quick,
                                  empty_key=name == "window")
            ok &= res["ok"]
            print(f"{'ok  ' if res['ok'] else 'FAIL'} flash_attention_backward {name} "
                  f"{json.dumps(res)}", flush=True)
    gating_ms = {}
    for name, (T, E, K, cf, bias) in GATING_BWD_CASES.items():
        res = check_gating_bwd(name, T if not args.quick else 256, E, K, cf, bias, gen,
                               timed=not args.quick)
        ok &= res["ok"]
        gating_ms[name] = res.get("ms")
        print(f"{'ok  ' if res['ok'] else 'FAIL'} moe_gating_backward {name} {json.dumps(res)}",
              flush=True)
    if not args.quick:
        print(f"launch floor: {json.dumps(launch_floor(gen, gating_ms))}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
