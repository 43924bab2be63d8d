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
  PYTHONPATH=src python -m repro_torch.launch.expert_kernels --capacity

``--variants`` also times the tensor-core kernel built from patched copies
of ``csrc/grouped_mlp_mma.cu`` (in ``build/``), in turns with the unpatched
one, at the timed shapes: without its weight loads (what the rest costs),
without the int8 / int4 widening (the raw bytes taken as bf16 fragments),
and with only its up/gate or only its down pass launched (beside the run
table), to show what bounds each format.  The outputs of a patched build
are not checked.  ``--splits`` checks and times the tensor-core kernel's
plan 0 at T = 4 and 8 with the down pass's contraction split across 1 to 6
blocks (``MmaPlan.split``), in turns.

``--capacity`` takes the capacity dispatch's kernels instead (and builds
``moe_gating`` too): kernel 3 (int8 experts over the ``[E, C, D]`` buffer)
with kernel 2 (the same experts in bf16) beside it, on llama4 tokens routed
by ``expert_capacity`` at T = 4, 8 and 256 (C = 8) and, kernel 3 alone, at
13926 tokens (C = 136), each per row against its plain versions (kernel 3:
``expert_mlp_quant_plain`` and the tensor-core order's
``expert_mlp_quant_mma_plain``) and kernel 3 against the function in f64 on
the exact weights, its worst row no farther than ``expert_mlp_quant_plain``'s;
the capacity run tables against their plain version; graph and host times
beside the bound; the tensor-core plans at C = 8 and 136 and the decode
split, checked and timed in turns.  Then kernel 1 at ``chip_smoke.py``'s
phase 10 cases and past the one-launch slot bound, integer outputs identical
to its plain version, graph and host times, and its one- and two-launch
paths timed in turns over T*K.  Against another tree (whose wrappers may
lack the tensor-core path) it times what that tree has.

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
                same = gk.tables_equal(table, want)
                res[f"run_table_R{R}"] = {"n_runs": int(want[-1]), "equal": same}
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


def capacity_bound(moe, xe, fill, n_assign) -> dict:
    """The bound of kernels 2 / 3 on these inputs: the weights of the experts
    with tokens, the kept input rows, the whole [E, C, D] output and the
    fill, over the memory rate; or 2 * kept * 3 * D * F operations over the
    peak of xe's dtype, whichever is larger."""
    E, D, F = moe["wi"].shape
    C = xe.shape[1]
    kept = int(fill.clamp(max=C).sum().item())
    live = int((fill > 0).sum().item())
    need = live * expert_bytes(moe) + (kept + E * C) * D * xe.element_size() + E * 4
    ops = 2 * kept * 3 * D * F
    b, o = need / HBM_BYTES_PER_S, ops / PEAK_OPS[xe.dtype]
    return {"C": C, "kept": kept, "dropped": n_assign - kept, "live_experts": live,
            "bound_ms": max(b, o) * 1e3, "bound_by": "bytes" if b >= o else "operations",
            "bytes": need, "ops": ops}


def capacity_routed(moe, x, K, cf=1.25):
    """The capacity expert MLP's inputs as the MoE layer builds them from
    tokens x [T, D]: routed by ``moe``'s router with ``expert_capacity``
    slots an expert, scattered into the [E, C, D] buffer, the gating's
    counts as fill; and its bound."""
    from repro_torch.core.dispatch import dispatch_dense
    from repro_torch.core.gating import expert_capacity
    from repro_torch.kernels.moe_gating import gating_plain

    T, D = x.shape
    E = moe["wi"].shape[0]
    cap = expert_capacity(T, E, K, cf)
    g, counts = gating_plain(x.float() @ moe["router"], K, cap)
    xe = dispatch_dense(x, g, cap, E)
    info = {"T": T, "K": K, "E": E, **capacity_bound(moe, xe, counts, T * K)}
    return (xe, moe["wi"], moe["wg"], moe["wo"], counts), info


def exact_capacity(xe, wi, wg, wo, fill):
    """Kernel 3's function in f64 on the exact weights q * s, over the
    capacity buffer (``exact``'s, expert by expert)."""
    from repro_torch.quant.qarrays import dequantize_values

    def w(q, e):
        vals = dequantize_values(q.q[e], torch.ones_like(q.scale[e]), q.bits, 0, q.axis, torch.float32)
        return vals.double() * q.scale[e].double()

    out = torch.zeros(xe.shape, dtype=torch.float64, device=xe.device)
    for e in torch.nonzero(fill > 0).flatten().tolist():
        x = xe[e].double()
        act = (torch.nn.functional.silu(x @ w(wg, e)) * (x @ w(wi, e))).to(xe.dtype).double()
        out[e] = act @ w(wo, e)
    return out


class Capacity(Cases):
    def tokens(self, T, D):
        return self.randn(T, D, dtype=torch.bfloat16)

    def check(self, name, moe, args, info, timed=False, plan=None):
        """Kernel 3 (int8 ``moe``) or kernel 2 against its plain versions per
        row; kernel 3 against ``exact_capacity``, the tensor-core kernel's
        worst row no farther than the plain version's; the capacity run
        tables; ``plan``: a tensor-core launch with its own ``MmaPlan``."""
        import inspect

        from repro_torch.kernels import expert_mlp as k2
        from repro_torch.kernels import expert_mlp_grouped as gk
        from repro_torch.kernels import expert_mlp_quant as k3

        quant = not torch.is_tensor(moe["wi"])
        n_assign = info["T"] * info["K"]
        if not quant:
            fn = lambda: k2.expert_mlp(*args)
            plains = {"plain": k2.expert_mlp_plain}
        else:
            xe, wi, wg, wo, fill = args
            if plan is not None:
                fn = lambda: gk.launch_capacity_mma(xe, fill, (wi.q, wi.scale), (wg.q, wg.scale),
                                                    (wo.q, wo.scale), "expert_mlp_quant",
                                                    n_assign, plan)
            elif "n_assign" in inspect.signature(k3.expert_mlp_quant).parameters:
                fn = lambda: k3.expert_mlp_quant(*args, n_assign=n_assign)
            else:  # a tree without the tensor-core path
                fn = lambda: k3.expert_mlp_quant(*args)
            plains = {"plain": k3.expert_mlp_quant_plain}
            if hasattr(k3, "expert_mlp_quant_mma_plain"):
                plains["mma_plain"] = k3.expert_mlp_quant_mma_plain
        counts = getattr(k3, "variant_launches", None) if quant else None
        before = dict(counts) if counts is not None else None
        out = fn()
        torch.cuda.synchronize()
        res, ok = dict(info), True
        if plan is not None:
            res["plan"] = tuple(plan)
        elif counts is not None:
            res["variant"] = [k for k in counts if counts[k] != before[k]]
            if quant and hasattr(gk, "capacity_mma_plan"):
                res["plan"] = tuple(gk.capacity_mma_plan(info["E"], info["C"], n_assign, 8))
        refs = {}
        for label, plain in plains.items():
            refs[label] = plain(*args)
            r = res[label] = rows(out, refs[label])
            ok &= bool(r.get("finite", True) and r["max_rel_err"] <= BF16_TOL
                       and r["max_row_rel_err"] <= BF16_TOL and r["zero_rows_max"] == 0)
        if quant:
            ex = exact_capacity(*args)
            res["vs_f64"] = {"kernel": rows(out, ex)["max_row_rel_err"],
                             "plain": rows(refs["plain"], ex)["max_row_rel_err"]}
            if plan is not None or res.get("variant") == ["expert_mlp_quant_mma"]:
                ok &= res["vs_f64"]["kernel"] <= res["vs_f64"]["plain"]
            del ex
        if quant and hasattr(gk, "capacity_run_table") and plan is None:
            fill = args[-1]
            C = info["C"]
            wild = fill * 7 - 3  # past C and negative
            for R in (1, 8):
                for label, f in (("fill", fill), ("wild", wild)):
                    same = gk.tables_equal(gk.capacity_run_table(f, C, R).cpu(),
                                           gk.capacity_run_table_plain(f.cpu(), C, R))
                    res[f"run_table_{label}_R{R}"] = same
                    ok &= same
        del out, refs
        if timed:
            n = 3 if info["T"] > 1000 else 20
            res["ms"] = graph_ms(fn, n=n)
            res["host_ms"] = host_ms(fn, n=n)
        self.ok &= bool(ok)
        print(f"{'ok  ' if ok else 'FAIL'} {name} {json.dumps(res)}", flush=True)
        return fn


def gating_cases(c, router):
    """``chip_smoke.py``'s phase 10 gating cases: (name, logits, K, capacity)."""
    from repro_torch.core.gating import expert_capacity

    E = router.shape[1]
    out = []
    for T in (4, 8, 256):
        x = c.randn(T, router.shape[0], dtype=torch.bfloat16)
        out.append((f"served router T {T}", x.float() @ router, 1, expert_capacity(T, E, 1, 1.25)))
    out.append(("kimi-k2 width T 256, E 384, K 8", c.randn(256, 384), 8,
                expert_capacity(256, 384, 8, 1.25)))
    ties = (c.randn(256, E) * 2).round() / 2
    ties[::4] = 0.5
    out.append(("ties, K 2", ties, 2, expert_capacity(256, E, 2, 1.25)))
    skew = c.randn(256, E)
    skew[:, 0] += 4.0
    out.append(("drops", skew, 1, expert_capacity(256, E, 1, 1.25)))
    out.append(("past the one-launch bound, T 13926", c.randn(13926, E), 1,
                expert_capacity(13926, E, 1, 1.25)))
    return out


def check_gating(c, name, logits, K, cap, one_launch=None):
    """Kernel 1 against its plain version: integer outputs identical, w and
    probs within 1e-6; graph and host times.  ``one_launch`` forces a path
    (None: ``gating``'s rule).  Returns the timed call."""
    from repro_torch.kernels import moe_gating as k1

    if one_launch is None:
        fn = lambda: k1.gating(logits, K, cap)
    else:
        fn = lambda: k1._gating(logits, K, cap, True, one_launch)
    counts = getattr(k1, "variant_launches", None)
    before = dict(counts) if counts is not None else None
    g, n = fn()
    pg, pn = k1.gating_plain(logits, K, cap)
    torch.cuda.synchronize()
    ok = all(torch.equal(getattr(g, a), getattr(pg, a)) for a in ("expert_idx", "position", "keep"))
    ok &= torch.equal(n, pn)
    err = max((g.combine_w - pg.combine_w).abs().max().item(), (g.probs - pg.probs).abs().max().item())
    ok &= err <= 1e-6
    res = {"T": logits.shape[0], "E": logits.shape[1], "K": K, "capacity": cap, "max_abs_err": err,
           "dropped": int((~g.keep).sum().item())}
    if counts is not None:
        res["variant"] = [k for k in counts if counts[k] != before[k]]
    res["ms"] = graph_ms(fn)
    res["host_ms"] = host_ms(fn)
    c.ok &= bool(ok)
    print(f"{'ok  ' if ok else 'FAIL'} moe_gating {name} {json.dumps(res)}", flush=True)
    return fn


def capacity_main(c, gen) -> None:
    """``--capacity``: kernels 3 and 2 at the capacity dispatch's shapes, the
    tensor-core plans, then kernel 1."""
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.kernels import moe_gating as k1
    from repro_torch.quant.qarrays import QuantizedArray

    bf = experts(LLAMA4, gen)
    q8 = {**{n: QuantizedArray.quantize(bf[n], bits=8) for n in ("wi", "wg", "wo")},
          "router": bf["router"]}
    D, K = LLAMA4["D"], LLAMA4["K"]
    mma = hasattr(gk, "launch_capacity_mma")
    for T in (4, 8, 256, 13926):
        x = c.tokens(T, D)
        a, info = capacity_routed(q8, x, K)
        c.check(f"expert_mlp_quant int8 T {T}", q8, a, info, timed=True)
        if mma and T in (4, 8):
            for split in (1, 2, 3, 4):
                c.check(f"expert_mlp_quant int8 T {T} plan 0 split {split}", q8, a, info, timed=True,
                        plan=gk.MmaPlan(1, 0, split))
        if mma and T in (256, 13926):
            for plan in (gk.MmaPlan(1, 0), gk.MmaPlan(8, 2)):
                c.check(f"expert_mlp_quant int8 T {T} plan {tuple(plan)}", q8, a, info, timed=True,
                        plan=plan)
        if T < 1000:
            a2, info2 = capacity_routed(bf, x, K)
            c.check(f"expert_mlp bf16 T {T}", bf, a2, info2, timed=True)
            del a2
        del a, x
        torch.cuda.empty_cache()
    router = bf["router"]
    del bf, q8
    torch.cuda.empty_cache()
    for name, logits, k, cap in gating_cases(c, router):
        check_gating(c, name, logits, k, cap)
    if hasattr(k1, "_gating"):  # the one-launch bound: both paths in turns over T*K
        calls = {}
        for T, E, k in ((4, 128, 1), (256, 128, 1), (1024, 128, 1), (4096, 128, 1),
                        (13926, 128, 1), (256, 384, 8), (1024, 384, 8)):
            logits = c.randn(T, E)
            cap = max(8, T * k // E)
            for one in (True, False):
                calls[f"T {T} E {E} K {k} one_launch {one}"] = check_gating(
                    c, f"T {T} E {E} K {k} one_launch {one}", logits, k, cap, one_launch=one)
        names = list(calls)
        for name in names + names[::-1]:
            print(f"moe_gating {name}: {graph_ms(calls[name]):.5f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long-only", action="store_true", help="only the timed cases")
    ap.add_argument("--variants", action="store_true",
                    help="also time the tensor-core kernel without its weight loads, without "
                    "the int8 / int4 widening, and each of its passes alone")
    ap.add_argument("--splits", action="store_true",
                    help="also check and time plan 0 at T = 4 and 8 with the down pass's "
                    "contraction split across blocks")
    ap.add_argument("--capacity", action="store_true",
                    help="kernels 3, 2 and 1 (the capacity dispatch) instead of 4 and 5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("expert_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.quant.qarrays import QuantizedArray

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    names = [n for n in ("grouped_mlp", "grouped_mlp_mma", "moe_gating")[: 3 if args.capacity else 2]
             if n in build.sources()]
    build.build(names)
    print(f"build {time.perf_counter() - t0:.1f} s ({', '.join(names)}); "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for n in names:
        for line in build.build_log(n).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.capacity:
        c = Capacity()
        capacity_main(c, gen)
        print("all cases agree" if c.ok else "SOME CASES DISAGREE", flush=True)
        return 0 if c.ok else 1
    c = Grouped()
    c.tables = not args.long_only and hasattr(gk, "run_table")
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
