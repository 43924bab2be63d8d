"""Per-row checks and CUDA-graph timings of the grouped expert MLP kernels 4
(bf16 weights) and 5 (int8 and int4 weights, per-output-column scales) on
the card, each held per token row against its plain version: at
llama4-maverick's expert width (128 experts, D 5120, F 8192, top-1, random
weights from a seed) at T = 4 (static decode), 8 (the continuous engine's 8
slots), 256 (static prefill, a continuous chunk) and 16384 tokens (the long
prefill), on random tokens routed by a random router; at kimi-k2-1t-a32b's
width (D 7168, F 2048, top-8, 32 experts) at T = 64; on routings that
stress the run table (every token on one expert, T = 1, top-2); and on
tile -> expert maps that cycle over three experts, with more runs than the
grid has rows.  Timed cases report ``ms`` (device time from a CUDA graph
of the calls), ``host_ms`` (one wrapper call on the host's clock) and their
bound (``grouped_bound``: the weights of the experts the live tiles touch,
the live input rows, the whole output and the tile entries, over 3.35 TB/s;
or the operations over the dtype's peak, whichever is larger).  Kernel 5's
cases below 16384 tokens also hold the kernel and the plain version against
the function in f64 on the exact weights q * s (``exact``).  Where the
checkout has the tensor-core kernel, every case also checks its run table
against the plain version.

  PYTHONPATH=src python -m repro_torch.launch.expert_kernels [--long-only] [--variants] [--splits]

``--variants`` also times the tensor-core kernel built from patched copies
of ``csrc/grouped_mlp_mma.cu`` (in ``build/``), in turns with the unpatched
one, at the timed shapes: without its weight loads (what the rest costs),
without the int8 / int4 widening (the raw bytes taken as bf16 fragments),
and with only its up/gate or only its down pass launched (beside the run
table), to show what bounds each format.  The outputs of a patched build
are not checked.  ``--splits`` checks and times the tensor-core kernel's
plan 0 at T = 4 and 8 with the down pass's contraction split across 1 to 6
blocks (``MmaPlan.split``), in turns.

It builds only the two grouped sources, so it is the quick loop for work on
these kernels; to compare with another checkout, run this file from this
tree with that checkout's ``src`` first on PYTHONPATH, in the same call,
with ``--long-only``.  Prints one line per case; exits non-zero if a case
disagrees.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.launch.attention_kernels import host_ms
from repro_torch.launch.paged_kernels import BF16_TOL, Cases, graph_ms, rows

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 700 W
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
LLAMA4 = dict(E=128, D=5120, F=8192, K=1)
KIMI = dict(E=32, D=7168, F=2048, K=8)
SERVED_T = (4, 8, 256)
LONG_T = 16384
TILE = 8


def experts(width, gen, bits=0):
    """Random SwiGLU experts and a router at ``width`` (bf16, fan-in
    scaled), quantized per output column to ``bits`` (8, 4) if given."""
    from repro_torch.models.modules import dense_init
    from repro_torch.quant.qarrays import QuantizedArray

    E, D, F = width["E"], width["D"], width["F"]
    moe = {"wi": dense_init(gen, D, F, torch.bfloat16, "cuda", lead=(E,)),
           "wg": dense_init(gen, D, F, torch.bfloat16, "cuda", lead=(E,)),
           "wo": dense_init(gen, F, D, torch.bfloat16, "cuda", lead=(E,)),
           "router": dense_init(gen, D, E, torch.float32, "cuda")}
    if bits:
        for n in ("wi", "wg", "wo"):
            moe[n] = QuantizedArray.quantize(moe[n], bits=bits)
    return moe


def expert_bytes(moe) -> int:
    """Bytes of one expert's wi, wg and wo: values in their type, or int8 /
    packed int4 values plus their f32 column scales."""
    total = 0
    for n in ("wi", "wg", "wo"):
        w = moe[n]
        total += (w[0].numel() * w.element_size() if torch.is_tensor(w)
                  else w.q[0].numel() + w.scale[0].numel() * 4)
    return total


def grouped_bound(moe, xg, te, rows_used, n_assign) -> dict:
    """The bound of kernels 4 / 5 on these inputs: the weights of the experts
    the live tiles touch, the live input rows and their tile -> expert
    entries, rows_used, and the whole [Ct, D] output (dead rows are zeros
    the function returns; tiles past rows_used read nothing else), over the
    memory rate; or 2 * n_assign * 3 * D * F operations over the peak of
    xg's dtype, whichever is larger."""
    E, D, F = moe["wi"].shape
    Ct = xg.shape[0]
    used = int(rows_used.item())
    n_exp = int(torch.unique(te[: used // TILE]).numel())
    need = n_exp * expert_bytes(moe) + (used + Ct) * D * xg.element_size() + (used // TILE + 1) * 4
    ops = 2 * n_assign * 3 * D * F
    b, o = need / HBM_BYTES_PER_S, ops / PEAK_OPS[xg.dtype]
    return {"Ct": Ct, "rows_used": used, "distinct_experts": n_exp, "bound_ms": max(b, o) * 1e3,
            "bound_by": "bytes" if b >= o else "operations", "bytes": need, "ops": ops}


def routed(moe, x, K, logits=None):
    """The grouped MLP's inputs as the MoE layer builds them from tokens x
    [T, D] (routed by ``moe``'s router, or by ``logits``), and its bound."""
    from repro_torch.core.dispatch_grouped import grouped_layout
    from repro_torch.core.gating import top_k_gating

    T, D = x.shape
    E, _, F = moe["wi"].shape
    g = top_k_gating(x.float() @ moe["router"] if logits is None else logits, K, T * K)
    lay = grouped_layout(g, E)
    Ct = lay.tile_expert.shape[0] * TILE
    xg = torch.zeros((Ct, D), dtype=x.dtype, device="cuda")
    xg[lay.dst] = x[torch.arange(T * K, device="cuda") // K]
    info = {"T": T, "K": K, "E": E, "D": D, "F": F,
            **grouped_bound(moe, xg, lay.tile_expert, lay.rows_used, T * K)}
    return (xg, lay.tile_expert, moe["wi"], moe["wg"], moe["wo"], lay.rows_used), info


def cycled(moe, n_tiles, live, x):
    """Inputs no dispatch makes: ``n_tiles`` tiles whose experts cycle over
    0, 1, 2 (every tile its own run), the first ``live`` live, rows from
    ``x`` [n_tiles * 8, D]."""
    E, D, F = moe["wi"].shape
    te = (torch.arange(n_tiles, device="cuda") % 3).to(torch.int32)
    used = torch.tensor([live * TILE], dtype=torch.int32, device="cuda")
    info = {"T": live * TILE, "K": 1, "E": E, "D": D, "F": F,
            **grouped_bound(moe, x, te, used, live * TILE)}
    return (x, te, moe["wi"], moe["wg"], moe["wo"], used), info


def exact(xg, te, wi, wg, wo, rows_used):
    """Kernel 5's function in f64 on the exact weights q * s: products and
    sums in f64, the activation rounded to xg's type as the function asks,
    the output left in f64."""
    from repro_torch.quant.qarrays import dequantize_values

    def w(q, e):
        vals = dequantize_values(q.q[e], torch.ones_like(q.scale[e]), q.bits, 0, q.axis, torch.float32)
        return vals.double() * q.scale[e].double()

    nt = te.shape[0]
    live = min(int(rows_used.item()) // TILE, nt)
    row_e = torch.where(torch.arange(nt, device=te.device) < live, te.long(), -1).repeat_interleave(TILE)
    out = torch.zeros(xg.shape, dtype=torch.float64, device=xg.device)
    for e in torch.unique(te[:live]).tolist():
        rows_e = row_e == e
        x = xg[rows_e].double()
        h, g = x @ w(wi, e), x @ w(wg, e)
        act = (torch.nn.functional.silu(g) * h).to(xg.dtype).double()
        out[rows_e] = act @ w(wo, e)
    return out


def mma_call(args, plan):
    """One call of the tensor-core kernel with an explicit ``MmaPlan``."""
    from repro_torch.kernels import expert_mlp_grouped as gk

    xg, te, wi, wg, wo, used = args
    if torch.is_tensor(wi):
        return lambda: gk._launch_mma(xg, te, used, (wi, None), (wg, None), (wo, None), 0,
                                      "grouped_mlp", plan)
    return lambda: gk._launch_mma(xg, te, used, (wi.q, wi.scale), (wg.q, wg.scale),
                                  (wo.q, wo.scale), wi.bits, "grouped_mlp_quant", plan)


class Grouped(Cases):
    tables = True  # check run tables (needs this tree's kernels/expert_mlp_grouped.py)

    def check(self, name, moe, args, info, timed=False, call=None):
        """Kernel 4 / 5 (or ``call``, a tensor-core launch with its own plan)
        against the plain version per row, and, for kernel 5 below 16384
        tokens, both against ``exact``."""
        from repro_torch.kernels import expert_mlp_grouped as gk

        quant = not torch.is_tensor(moe["wi"])
        kernel = gk.grouped_mlp_quant if quant else gk.grouped_mlp
        plain = gk.grouped_mlp_quant_plain if quant else gk.grouped_mlp_plain
        fn = call or (lambda: kernel(*args))
        counts = getattr(gk, "variant_launches", None)
        before = dict(counts) if counts is not None else None
        out = fn()
        torch.cuda.synchronize()
        ref = plain(*args)
        res = {**info, **rows(out, ref)}
        if counts is not None and call is None:
            res["variant"] = [k for k in counts if counts[k] != before[k]]
        ok = (res.get("finite", True) and res["max_rel_err"] <= BF16_TOL
              and res["max_row_rel_err"] <= BF16_TOL and res["zero_rows_max"] == 0)
        if quant and info["T"] < LONG_T:
            ex = exact(*args)
            res["vs_f64"] = {"kernel": rows(out, ex)["max_row_rel_err"],
                             "plain": rows(ref, ex)["max_row_rel_err"]}
            del ex
        if self.tables and call is None:
            xg, te, *_, used = args
            for R in (1, 8, 16):
                table = gk.run_table(te, used, R).cpu()
                want = gk.run_table_plain(te.cpu(), used.cpu(), R)
                n = int(want[-1])  # entries past n_runs + 1 are not written
                same = int(table[-1]) == n and torch.equal(table[: n + 1], want[: n + 1])
                res[f"run_table_R{R}"] = {"n_runs": n, "equal": same}
                ok &= same
        del out, ref
        if timed:
            res["ms"] = graph_ms(fn, n=3 if info["T"] >= LONG_T else 20)
            res["host_ms"] = host_ms(fn, n=3 if info["T"] >= LONG_T else 20)
        self.ok &= bool(ok)
        print(f"{'ok  ' if ok else 'FAIL'} {name} {json.dumps(res)}", flush=True)

    def tokens(self, T, D):
        return self.randn(T, D, dtype=torch.bfloat16)


# Patches for --variants: (anchor, replacement) pairs applied to a copy of
# csrc/grouped_mlp_mma.cu; each anchor must be found.
_NO_WEIGHT_LOADS = ("""        cp_async16(st + (m * P::WC + grp) * Fm::BYTES + Fm::off(k, ch),
                   w[m] + (row0 + k) * ldw + grp * Fm::ROWB + ch * 16, true);""",
                    """        (void)k; (void)ch; (void)grp; (void)row0;""")
_NO_WIDEN_8 = ("""          int8x4_to_bf16(__byte_perm(w[2 * h], w[2 * h + 1], 0x5140), a[m][0][s][2 * h], a[m][0][s][2 * h + 1]);
          int8x4_to_bf16(__byte_perm(w[2 * h], w[2 * h + 1], 0x7362), a[m][1][s][2 * h], a[m][1][s][2 * h + 1]);""",
               """          a[m][0][s][2 * h] = w[2 * h]; a[m][0][s][2 * h + 1] = w[2 * h + 1];
          a[m][1][s][2 * h] = w[2 * h] ^ 1u; a[m][1][s][2 * h + 1] = w[2 * h + 1] ^ 1u;""")
_NO_WIDEN_4 = ("""            const uint32_t y = __byte_perm(u, v, 0x4400 + 0x1111 * c);  // byte c of u and of v
            uint32_t r = (y & 0x000F000Fu) | 0x43004300u;  // bf16 pair 128 + u_lo, 128 + u_hi
            __nv_bfloat162 b = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r), bias);
            a[m][c >> 1][s][2 * h + (c & 1)] = *reinterpret_cast<uint32_t*>(&b);""",
               """            (void)bias; (void)v;
            a[m][c >> 1][s][2 * h + (c & 1)] = u + c;""")
_UP_ONLY = [("""  mma_pass<BITS, 1, P><<<dim3(D / P::BN, max_runs, split)""",
             """  if (false) mma_pass<BITS, 1, P><<<dim3(D / P::BN, max_runs, split)"""),
            ("""  if (split > 1)\n    merge_splits""", """  if (false)\n    merge_splits""")]
_DOWN_ONLY = [("""  mma_pass<BITS, 2, P><<<dim3(F / P::BN, max_runs)""",
               """  if (false) mma_pass<BITS, 2, P><<<dim3(F / P::BN, max_runs)""")]
VARIANTS = {"kernel": [], "no_weight_loads": [_NO_WEIGHT_LOADS],
            "no_widen": [_NO_WIDEN_8, _NO_WIDEN_4], "up_only": _UP_ONLY,
            "down_only": _DOWN_ONLY}


def build_variants() -> dict:
    """Every patched copy of VARIANTS built at once: {variant: CDLL}."""
    import ctypes
    import shutil
    import subprocess

    from repro_torch.kernels import build

    root = build.BUILD_DIR / "variants_expert"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build.CSRC, root / "csrc")
    src = (build.CSRC / "grouped_mlp_mma.cu").read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for anchor, repl in patches:
            if anchor not in text:
                raise RuntimeError(f"variant {name}: anchor not found in grouped_mlp_mma.cu")
            text = text.replace(anchor, repl)
        (root / "csrc" / f"grouped_mlp_mma_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(root / f"lib{name}.so"),
             str(root / "csrc" / f"grouped_mlp_mma_{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
    return {name: ctypes.CDLL(str(root / f"lib{name}.so")) for name in procs}


def time_variants(libs, cases):
    """Each variant swapped in for the wrapper's library and timed on each
    of ``cases`` ({label: call}) from CUDA graphs, in turns (every variant
    twice, in opposite orders)."""
    from repro_torch.kernels import build

    names = list(VARIANTS)
    loaded = build._loaded.get("grouped_mlp_mma")
    try:
        for name in names + names[::-1]:
            build._loaded["grouped_mlp_mma"] = libs[name]
            for label, (call, n) in cases.items():
                print(f"grouped_mlp_mma variant {name}: {label}: {graph_ms(call, n=n):.4f} ms",
                      flush=True)
    finally:
        if loaded is None:
            build._loaded.pop("grouped_mlp_mma", None)
        else:
            build._loaded["grouped_mlp_mma"] = loaded


def sweep_splits(c, fmt, bits, moe, xs):
    """``--splits``: plan 0 at T = 4 and 8 with the down pass's contraction
    split across 1, 2, 3, 4 and 6 blocks, each checked per row, then timed
    from CUDA graphs in turns (every split twice, in opposite orders)."""
    from repro_torch.kernels import expert_mlp_grouped as gk

    calls = {}
    for T in (4, 8):
        a, info = routed(moe, xs[T], LLAMA4["K"])
        print(f"{fmt} T {T}: mma_plan {tuple(gk.mma_plan(info['Ct'] // TILE, info['E'], bits))}",
              flush=True)
        for split in (1, 2, 3, 4, 6):
            call = mma_call(a, gk.MmaPlan(1, 0, split))
            c.check(f"llama4 {fmt} T {T} plan 0 split {split}", moe, a, info, call=call)
            calls[f"{fmt} T {T} split {split}"] = call
    names = list(calls)
    for name in names + names[::-1]:
        print(f"grouped_mlp_mma {name}: {graph_ms(calls[name]):.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long-only", action="store_true", help="only the timed cases")
    ap.add_argument("--variants", action="store_true",
                    help="also time the tensor-core kernel without its weight loads, without "
                    "the int8 / int4 widening, and each of its passes alone")
    ap.add_argument("--splits", action="store_true",
                    help="also check and time plan 0 at T = 4 and 8 with the down pass's "
                    "contraction split across blocks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("expert_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.quant.qarrays import QuantizedArray

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    names = [n for n in ("grouped_mlp", "grouped_mlp_mma") if n in build.sources()]
    build.build(names)
    print(f"build {time.perf_counter() - t0:.1f} s ({', '.join(names)}); "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for n in names:
        for line in build.build_log(n).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}", flush=True)
    c = Grouped()
    c.tables = not args.long_only and hasattr(gk, "run_table")
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed_calls = {}
    bf = experts(LLAMA4, gen)
    D = LLAMA4["D"]
    xs = {T: c.tokens(T, D) for T in (*SERVED_T, LONG_T)}
    xc = c.tokens(400 * TILE, D)
    formats = [("bf16", None), ("int8", 8), ("int4", 4)]
    for fmt, bits in formats:
        moe = bf if bits is None else {**{n: QuantizedArray.quantize(bf[n], bits=bits)
                                          for n in ("wi", "wg", "wo")}, "router": bf["router"]}
        for T in (*SERVED_T, LONG_T):
            a, info = routed(moe, xs[T], LLAMA4["K"])
            c.check(f"llama4 {fmt} T {T}", moe, a, info, timed=True)
            if args.variants:
                kern = gk.grouped_mlp_quant if bits else gk.grouped_mlp
                timed_calls[f"{fmt} T {T}"] = (lambda k=kern, a=a: k(*a), 3 if T >= LONG_T else 20)
            del a
        if not args.long_only:
            skew = torch.full((256, LLAMA4["E"]), -4.0, device="cuda")
            skew[:, 7] = 4.0  # every token on expert 7: 32 tiles, runs of 8
            skew[::5, 3] = 5.0  # a fifth on expert 3
            for name, x, K, logits in (("T 256 skewed to two experts", xs[256], 1, skew),
                                       ("T 1", xs[4][:1].contiguous(), 1, None),
                                       ("T 100 top-2", xs[256][:100].contiguous(), 2, None)):
                a, info = routed(moe, x, K, logits=logits)
                c.check(f"llama4 {fmt} {name}", moe, a, info)
            # more runs than grid rows: 400 runs on 178 rows (plan 2), and 20
            # on 7 (plan 0, split: the runs past the grid's first pass whole)
            for nt, live in ((400, 400), (112, 20)):
                a, info = cycled(moe, nt, live, xc[: nt * TILE])
                c.check(f"llama4 {fmt} te cycling over 3 experts, {nt} tiles, {live} live", moe, a,
                        info)
            del a
        if args.splits:
            sweep_splits(c, fmt, bits or 0, moe, xs)
        del moe
        torch.cuda.empty_cache()
    if args.variants and "grouped_mlp_mma" in names:
        time_variants(build_variants(), timed_calls)
    del bf, xs, xc, timed_calls
    torch.cuda.empty_cache()
    if not args.long_only:
        kimi = experts(KIMI, gen)
        x = c.tokens(64, KIMI["D"])
        for fmt, bits in formats:
            moe = kimi if bits is None else {**{n: QuantizedArray.quantize(kimi[n], bits=bits)
                                                for n in ("wi", "wg", "wo")}, "router": kimi["router"]}
            a, info = routed(moe, x, KIMI["K"])
            c.check(f"kimi-k2 width {fmt} T 64 top-8", moe, a, info, timed=True)
    print("all cases agree" if c.ok else "SOME CASES DISAGREE", flush=True)
    return 0 if c.ok else 1


if __name__ == "__main__":
    sys.exit(main())
