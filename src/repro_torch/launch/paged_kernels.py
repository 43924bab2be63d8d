"""Per-row checks and CUDA-graph timings of the paged attention kernels on the
card: kernels 7 / 7q (decode) and 8 / 8q (chunk prefill, single-row and
batched) in bf16 and f32, each held per query row against its plain
version, at the served llama4 shapes (8 kv-heads, G = 5, dh 128, page size
16, 128 table entries), at stress shapes (rows of about 1800 tokens, tables
of several compaction windows, glm4's and nlg-350m-moe128's heads, a window
and a softcap), and, with ``--splits``, kernel 7 timed at several split
counts.  ``--batched-only`` runs the batched kernel 8 / 8q's cases alone (8
rows of 256-query chunks over 0-1777 tokens of history, one row inactive,
one of 40 queries and padding), timed beside the same rows as 8 single-row
launches.

  PYTHONPATH=src python -m repro_torch.launch.paged_kernels [--splits] [--batched-only]

It builds only the two paged sources, so it is the quick loop for work on
these kernels; run it from two checkouts in one call on the card to compare
them.  Prints one line per case; exits non-zero if a case disagrees.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

BF16_TOL, F32_TOL = 2e-2, 1e-5  # as chip_smoke.py's


def graph_ms(fn, n=20, reps=5) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph, the
    median over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def rows(out, ref) -> dict:
    """Largest |out - ref| relative to the largest |ref|, and per query row
    relative to that row's own largest |ref|; a row whose ref is 0 (no valid
    key) must be exactly 0."""
    o, p = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    if not torch.isfinite(o).all():
        return {"finite": False}
    zero = p.abs().amax(-1) == 0
    rel = ((o - p).abs().amax(-1) / p.abs().amax(-1).clamp_min(1e-30))[~zero]
    return {"max_rel_err": (o - p).abs().max().item() / max(p.abs().max().item(), 1e-30),
            "max_row_rel_err": rel.max().item() if rel.numel() else 0.0,
            "median_row_rel_err": rel.median().item() if rel.numel() else 0.0,
            "zero_rows": int(zero.sum()),
            "zero_rows_max": o[zero].abs().max().item() if zero.any() else 0.0}


class Cases:
    def __init__(self, seed=0):
        self.gen = torch.Generator(device="cuda").manual_seed(seed)
        self.ok = True

    def randn(self, *shape, dtype=torch.float32):
        return torch.randn(shape, generator=self.gen, device="cuda").to(dtype)

    def pool(self, Pt, ps, Hkv, dh, dtype, int8):
        from repro_torch.quant.kv import kv_quantize_values

        k, v = self.randn(Pt, ps, Hkv, dh, dtype=dtype), self.randn(Pt, ps, Hkv, dh, dtype=dtype)
        if not int8:
            return k, v, {}
        (k, ks), (v, vs) = kv_quantize_values(k), kv_quantize_values(v)
        return k, v, dict(k_scale=ks, v_scale=vs)

    def report(self, name, out, ref, tol, timed_fn=None):
        res = rows(out, ref)
        ok = (res.get("finite", True) and res["max_rel_err"] <= tol
              and res["max_row_rel_err"] <= tol and res["zero_rows_max"] == 0)
        if timed_fn is not None:
            res["ms"] = graph_ms(timed_fn)
        self.ok &= ok
        print(f"{'ok  ' if ok else 'FAIL'} {name} {json.dumps(res)}", flush=True)

    def prefill(self, n_hist, C, Hkv, G, dh, ps, Pt, nt, dtype, int8, kw, timed=False):
        """A chunk of C queries after n_hist tokens held in randomly drawn
        pages (the chunk's own pages mapped, fresh); trash past them."""
        from repro_torch.kernels import attention_prefill_paged as k8

        k, v, qkw = self.pool(Pt, ps, Hkv, dh, dtype, int8)
        kpos = torch.full((Pt, ps), -1, dtype=torch.int32, device="cuda")
        n_pages = -(-(n_hist + C) // ps)
        pages = torch.randperm(Pt - 1, generator=torch.Generator().manual_seed(0))[:n_pages].cuda()
        table = torch.full((nt,), Pt - 1, dtype=torch.int32, device="cuda")
        table[:n_pages] = pages.to(torch.int32)
        hist = torch.arange(n_hist, device="cuda")
        kpos[pages[hist // ps], hist % ps] = hist.to(torch.int32)
        qpos = torch.arange(n_hist, n_hist + C, dtype=torch.int32, device="cuda")
        args = (self.randn(C, Hkv, G, dh, dtype=dtype), k, v, kpos, table, qpos,
                self.randn(C, Hkv, dh, dtype=dtype), self.randn(C, Hkv, dh, dtype=dtype))
        kwa = dict(kw, **qkw)
        out = k8.paged_prefill_attention(*args, **kwa)
        torch.cuda.synchronize()
        ref = k8.paged_prefill_attention_plain(*args, **kwa)
        name = (f"kernel 8{'q' if int8 else ''} {str(dtype)[6:]} history {n_hist} C {C} Hkv {Hkv} "
                f"G {G} dh {dh} ps {ps} nt {nt} {kw}")
        self.report(name, out, ref, BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
                    (lambda: k8.paged_prefill_attention(*args, **kwa)) if timed else None)

    def decode(self, lens, Hkv, G, dh, ps, Pt, nt, dtype, int8, kw, timed=False):
        """One query per slot after lens[b] tokens held in randomly drawn
        pages (a length 0: an all-trash row)."""
        from repro_torch.kernels import attention_paged as k7

        k, v, qkw = self.pool(Pt, ps, Hkv, dh, dtype, int8)
        kpos = torch.full((Pt, ps), -1, dtype=torch.int32, device="cuda")
        table = torch.full((len(lens), nt), Pt - 1, dtype=torch.int32, device="cuda")
        perm = torch.randperm(Pt - 1, generator=torch.Generator().manual_seed(1)).cuda()
        used = 0
        for b, n in enumerate(lens):
            pages = perm[used:used + -(-n // ps)]
            used += pages.numel()
            table[b, :pages.numel()] = pages.to(torch.int32)
            hist = torch.arange(n, device="cuda")
            kpos[pages[hist // ps], hist % ps] = hist.to(torch.int32)
        qpos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32, device="cuda")
        args = (self.randn(len(lens), Hkv, G, dh, dtype=dtype), k, v, kpos, table, qpos)
        kwa = dict(kw, **qkw)
        out = k7.paged_decode_attention(*args, **kwa)
        torch.cuda.synchronize()
        ref = k7.paged_decode_attention_plain(*args, **kwa)
        shown = lens if len(lens) <= 8 else f"{len(lens)} slots of 0-{max(lens)}"
        name = (f"kernel 7{'q' if int8 else ''} {str(dtype)[6:]} lens {shown} Hkv {Hkv} G {G} "
                f"dh {dh} ps {ps} nt {nt} {kw}")
        self.report(name, out, ref, BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
                    (lambda: k7.paged_decode_attention(*args, **kwa)) if timed else None)

    def batched(self, hists, valid, C, Hkv, G, dh, ps, Pt, nt, dtype, int8, kw, timed=False):
        """The batched kernel 8 against its plain version per query row;
        padded queries and inactive rows must be exactly 0."""
        from repro_torch.kernels import attention_prefill_paged as k8

        args, qkw, info = batched_case(self.gen, hists, valid, C, Hkv, G, dh, ps, Pt, nt, dtype,
                                       int8)
        kwa = dict(kw, **qkw)
        out = k8.paged_prefill_attention_batched(*args, **kwa)
        torch.cuda.synchronize()
        ref = k8.paged_prefill_attention_batched_plain(*args, **kwa)
        pad = args[5] < 0
        zero_ok = out[pad].abs().max().item() == 0 if pad.any() else True
        name = (f"kernel 8{'q' if int8 else ''} batched {str(dtype)[6:]} histories {hists} valid "
                f"{valid} C {C} Hkv {Hkv} G {G} dh {dh} ps {ps} nt {nt} {kw}")
        if timed:
            singles = single_row_launches(args, kwa)
            print(f"     single-row launches x{len(hists)}: {graph_ms(singles, n=5):.5f} ms; bound "
                  f"{info['bound_ms']:.5f} ms ({info['bound_by']})", flush=True)
        self.ok &= zero_ok
        if not zero_ok:
            print(f"FAIL {name}: a padded or inactive query is not exactly 0", flush=True)
        self.report(name, out, ref, BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
                    (lambda: k8.paged_prefill_attention_batched(*args, **kwa)) if timed else None)


def batched_case(gen, hists, valid, C, Hkv, G, dh, ps, Pt, nt, dtype, int8):
    """The batched kernel 8's inputs: row b a chunk of C queries after
    ``hists[b]`` tokens of history on randomly drawn pages (None: an
    inactive row, positions and table all -1 / trash), its first
    ``valid[b]`` queries real and the rest padding (position -1).  Returns
    (args, kw with the int8 scales, info with the bound: per row the live
    entries' positions and the K/V of the history keys before the row's
    chunk start, q, out, ck, cv, the tables and positions in full, and 4 *
    H * dh operations per unmasked (query, key) pair)."""
    from repro_torch.quant.kv import kv_quantize_values

    dev = gen.device
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
    k, v = randn(Pt, ps, Hkv, dh), randn(Pt, ps, Hkv, dh)
    kw = {}
    if int8:
        (k, ks), (v, vs) = kv_quantize_values(k), kv_quantize_values(v)
        kw = dict(k_scale=ks, v_scale=vs)
    B = len(hists)
    kpos = torch.full((Pt, ps), -1, dtype=torch.int32, device=dev)
    tables = torch.full((B, nt), Pt - 1, dtype=torch.int32, device=dev)
    qpos = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(Pt - 1, generator=torch.Generator().manual_seed(2)).to(dev)
    used = pairs = live = 0
    kv_bytes = (dh + 4 if int8 else dh * k.element_size()) * 2 * Hkv  # a key's K and V, all heads
    need = 0
    for b, (n, nq) in enumerate(zip(hists, valid)):
        if n is None:
            continue
        pages = perm[used:used + -(-(n + nq) // ps)]
        used += pages.numel()
        tables[b, :pages.numel()] = pages.to(torch.int32)
        hist = torch.arange(n, device=dev)
        kpos[pages[hist // ps], hist % ps] = hist.to(torch.int32)
        qpos[b, :nq] = torch.arange(n, n + nq, dtype=torch.int32, device=dev)
        pairs += nq * n + nq * (nq + 1) // 2
        live += pages.numel()
        need += pages.numel() * ps * 4 + n * kv_bytes
    q, ck, cv = randn(B, C, Hkv, G, dh), randn(B, C, Hkv, dh), randn(B, C, Hkv, dh)
    el = q.element_size()
    need += (2 * q.numel() + 2 * ck.numel()) * el + tables.numel() * 4 + qpos.numel() * 4
    ops = 4 * Hkv * G * dh * pairs
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    b_ms, o_ms = need / 3.35e12 * 1e3, ops / peak * 1e3
    info = {"B": B, "C": C, "histories": hists, "valid": valid, "Hkv": Hkv, "G": G, "dh": dh,
            "ps": ps, "nt": nt, "live_entries": live, "pairs": pairs, "bytes": need, "ops": ops,
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}
    return (q, k, v, kpos, tables, qpos, ck, cv), kw, info


def single_row_launches(args, kw):
    """The batched case's rows as B launches of the single-row kernel 8."""
    from repro_torch.kernels import attention_prefill_paged as k8

    q, k, v, kpos, tables, qpos, ck, cv = args
    rows = [(q[b], tables[b], qpos[b], ck[b], cv[b]) for b in range(q.shape[0])]
    return lambda: [k8.paged_prefill_attention(qb, k, v, kpos, tb, pb, kb, vb, **kw)
                    for qb, tb, pb, kb, vb in rows]


SERVED = [1500, 0, 900, 1, 512, 60, 1777, 333]  # 8 slots of the continuous trace's prompts
FEW = [600, 0, 0, 580, 0, 0, 631, 0]  # 3 active slots, as the served snapshot mid-run
# the batched kernel 8's served case: 8 rows of 256-query chunks, one inactive
# (None), one of 40 queries and padding
BATCHED = [0, 256, 1008, 1777, None, 1008, 0, 1777]
BATCHED_VALID = [256, 256, 256, 256, 0, 256, 256, 40]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", action="store_true", help="also time kernel 7 at split counts")
    ap.add_argument("--batched-only", action="store_true", help="only the batched kernel 8's cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import attention_paged as k7
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["paged_decode_attention", "paged_prefill_attention"])
    print(f"build {time.perf_counter() - t0:.1f} s; {torch.cuda.get_device_name(0)}", flush=True)
    c = Cases()
    bf, f32 = torch.bfloat16, torch.float32
    s128, s64 = dict(scale=1 / math.sqrt(128)), dict(scale=1 / math.sqrt(64))
    ws = dict(scale=0.18, window=37, softcap=20.0)
    for int8 in (False, True):
        c.batched(BATCHED, BATCHED_VALID, 256, 8, 5, 128, 16, 1025, 128, bf, int8, s128, timed=True)
        c.batched([30, None, 0, 9], [40, 0, 13, 40], 40, 2, 4, 32, 8, 30, 16, bf, int8, ws)
        c.batched([30, None, 0, 9], [40, 0, 13, 40], 40, 2, 4, 32, 8, 30, 16, f32, int8, ws)
        c.batched([300, 0, None], [40, 7, 0], 40, 2, 16, 128, 16, 100, 64, bf, int8, s128)
        if args.batched_only:
            continue
        c.prefill(1008, 256, 8, 5, 128, 16, 345, 128, bf, int8, s128, timed=True)
        c.prefill(0, 256, 8, 5, 128, 16, 345, 128, bf, int8, s128, timed=True)
        c.prefill(1777, 256, 8, 5, 128, 16, 345, 128, bf, int8, s128, timed=True)
        c.prefill(1777, 40, 8, 5, 128, 16, 345, 128, bf, int8, s128)
        c.prefill(300, 40, 2, 16, 128, 16, 100, 64, bf, int8, s128)
        c.prefill(300, 40, 4, 1, 64, 8, 100, 64, bf, int8, s64)
        c.prefill(50, 40, 2, 4, 32, 8, 30, 16, bf, int8, ws)
        c.prefill(5000, 64, 2, 5, 64, 4, 1400, 1400, bf, int8, s64)  # 6 compaction windows
        c.prefill(50, 40, 2, 4, 32, 8, 30, 16, f32, int8, ws)
        c.decode(SERVED, 8, 5, 128, 16, 345, 128, bf, int8, s128, timed=True)
        c.decode(FEW, 8, 5, 128, 16, 345, 128, bf, int8, s128, timed=True)
        c.decode([1800, 1790, 1750, 1800, 1777, 1801, 0, 1], 8, 5, 128, 16, 900, 128, bf, int8,
                 s128, timed=True)
        c.decode([300, 0, 7], 2, 16, 128, 16, 100, 64, bf, int8, s128)
        c.decode([300, 0, 7], 4, 1, 64, 8, 100, 64, bf, int8, s64)
        c.decode([50, 0, 30], 2, 4, 32, 8, 30, 16, bf, int8, ws)
        lens = torch.randint(0, 2400, (34,), generator=torch.Generator().manual_seed(5)).tolist()
        c.decode(lens, 8, 5, 64, 4, 21000, 600, bf, int8, s64)  # one split, 3 windows a row
        c.decode([50, 0, 30], 2, 4, 32, 8, 30, 16, f32, int8, ws)
    if args.splits:
        chosen = k7.decode_splits
        for int8 in (False, True):
            for n in (1, 2, 5, 8, 16):
                k7.decode_splits = lambda *a, n=n: n
                print(f"decode splits {n}", flush=True)
                c.decode(SERVED, 8, 5, 128, 16, 345, 128, bf, int8, s128, timed=True)
                c.decode(FEW, 8, 5, 128, 16, 345, 128, bf, int8, s128, timed=True)
        k7.decode_splits = chosen
    print("all cases agree" if c.ok else "SOME CASES DISAGREE", flush=True)
    return 0 if c.ok else 1


if __name__ == "__main__":
    sys.exit(main())
