"""Per-row checks and CUDA-graph timings of kernels 6 (flash attention) and
9 (int8 contiguous decode) on the card, each held per query row against its
plain version: kernel 6 in bf16 at the served static prefill (4 x 64
tokens) with llama4-maverick's, glm4-9b's and nlg-350m-moe128's heads, at
reduced size with every mask, its head dims 32 and 112, the TPU kernel's
index form, and at long causal prompts (16384 tokens at llama4's heads,
4096 at nlg's), timed beside graph-timed SDPA; kernel 9 at the served
static cache (4 x 80 slots), a static cache sized for 2048 new tokens at
its first decode step (4 x 2112 slots, 80 filled), 8 x 2048 slots half
filled, a 16392-slot cache with 8 keys filled, a wrapped ring with a window,
glm4's and nlg's heads, timed beside SDPA over the cache dequantized
beforehand.  At recurrentgemma-2b's head dim 256 (10 heads over 1 kv-head,
window 2048): kernel 6 at reduced size with every mask (bf16 and f32), at 1
x 4096 tokens and the served static prefill of 4 x 1500, each timed beside
SDPA with the window-causal mask and checked bit for bit over two
launches; kernel 9 over a wrapped int8 ring of 8 x 2048 slots (timed), of
3 x 300 with every mask and a row with no valid key (bf16 and f32), and of
72 x 300 rows (one split a row); beside them the windowed dh-128 instances
at gemma3-27b's shapes (kernel 6 at 4 x 2048, kernel 9 over an 8 x 1024
ring), timed.  ``--long-only`` keeps the timed long cases.  Timed cases
also report ``host_ms``, one wrapper call's host time.

  PYTHONPATH=src python -m repro_torch.launch.attention_kernels [--long-only] [--variants]

``--variants`` also times kernels built from patched copies of their
sources (in ``build/``), in turns with the unpatched kernel: kernel 6 at
16384 tokens without its K/V loads, without its softmax, and without both,
to show what bounds it, and with its tiles marked by every block from the
row's positions in place of the tile summaries (at the served 4 x 64 and
at 1024 and 4096 tokens too, each also on the host's clock); kernel 9 without its position scan (every tile of the row taken as
live and masked per entry, as kernel 7 walks its rows), at its timed
shapes.  The outputs of a patched build are not checked.

It builds only the two sources, so it is the quick loop for work on these
kernels; to compare with another checkout, run this file from this tree
with that checkout's ``src`` first on PYTHONPATH, in the same call.  Prints
one line per case; exits non-zero if a case disagrees.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch.launch.paged_kernels import BF16_TOL, F32_TOL, Cases, graph_ms, rows

LLAMA4, GLM4, NLG = (40, 8, 128), (32, 2, 128), (16, 16, 64)  # (heads, kv-heads, head dim)
RGEMMA, GEMMA3 = (10, 1, 256), (32, 16, 128)  # recurrentgemma-2b's, gemma3-27b's


def sdpa_causal(q, k, v, scale):
    """Graph-timeable SDPA over [B, heads, tokens, dh] copies (causal, GQA)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]

    def call():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=scale,
                                                  enable_gqa=True)
    return call


def sdpa_window(q, k, v, q_pos, k_pos, scale, window):
    """Graph-timeable SDPA over [B, heads, tokens, dh] copies with the
    window-causal boolean mask (GQA); torch picks the backend."""
    import torch.nn.functional as F

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qp, kp = q_pos[:, None, :, None], k_pos[:, None, None, :]
    mask = (kp >= 0) & (kp <= qp) & (qp - kp < window)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)


def sdpa_decode_quant(q, kq, ks, vq, vs, kpos, qpos, scale, window=0):
    """SDPA over the int8 cache dequantized beforehand, the same mask."""
    import torch.nn.functional as F

    B, Hkv, G, dh = q.shape
    kg = (kq.float() * ks).to(q.dtype).transpose(1, 2).contiguous()
    vg = (vq.float() * vs).to(q.dtype).transpose(1, 2).contiguous()
    mask = (kpos >= 0) & (kpos <= qpos[:, None])
    if window > 0:
        mask = mask & (qpos[:, None] - kpos < window)
    mask = mask[:, None, None, :]
    qh = q.reshape(B, Hkv * G, 1, dh)
    return lambda: F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)


def host_ms(fn, n=20) -> float:
    """Host time of one call: ``n`` calls issued back to back (the device
    runs behind them), then one synchronize outside the window."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t) / n * 1e3
    torch.cuda.synchronize()
    return ms


class Attn(Cases):
    def report(self, name, out, ref, tol, timed_fn=None, library=None):
        """Per-row agreement (``rows``); ``ms`` and ``library_ms`` from CUDA
        graphs of the kernel's and SDPA's calls, ``host_ms`` the wrapper's."""
        res = rows(out, ref)
        ok = (res.get("finite", True) and res["max_rel_err"] <= tol
              and res["max_row_rel_err"] <= tol and res["zero_rows_max"] == 0)
        if timed_fn is not None:
            res["ms"] = graph_ms(timed_fn)
            res["host_ms"] = host_ms(timed_fn)
        if library is not None:
            res["library_ms"] = graph_ms(library)
        self.ok &= ok
        print(f"{'ok  ' if ok else 'FAIL'} {name} {json.dumps(res)}", flush=True)

    def flash(self, B, S, heads, dtype, kw=None, offsets=None, holes=False, zero_row=None,
              timed=False, sdpa=False, twice=False):
        """Kernel 6 over a static prefill of S tokens per row (positions
        offset per row by ``offsets``; ``holes``: every 7th key empty;
        ``zero_row``: a row with every key empty, which must give 0;
        ``twice``: a second launch must give the same bits)."""
        from repro_torch.kernels import flash_attention as k6

        H, Hkv, dh = heads
        q = self.randn(B, S, H, dh, dtype=dtype)
        k, v = self.randn(B, S, Hkv, dh, dtype=dtype), self.randn(B, S, Hkv, dh, dtype=dtype)
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S).contiguous()
        if offsets is not None:
            pos = (pos + torch.tensor(offsets, dtype=torch.int32, device="cuda")[:, None]).contiguous()
        kpos = pos.clone()
        if holes:
            kpos[:, 3::7] = -1
        if zero_row is not None:
            kpos[zero_row] = -1
        kwa = dict(scale=1.0 / math.sqrt(dh), causal=True, **(kw or {}))
        args = (q, k, v, pos, kpos)
        out = k6.flash_attention_gqa(*args, **kwa)
        torch.cuda.synchronize()
        ref = k6.flash_attention_plain(*args, **kwa)
        name = f"kernel 6 {str(dtype)[6:]} B {B} S {S} heads {heads} {kw or {}}"
        if holes or offsets is not None:
            name += f" holes {holes} offsets {offsets} zero_row {zero_row}"
        if hasattr(k6, "q_tile_rows") and dh in k6.WGMMA_HEAD_DIMS and dtype == torch.bfloat16:
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            try:
                tile = k6.q_tile_rows(S, H, B, n_sm, dh)
            except TypeError:  # a tree whose q_tile_rows does not take the head dim
                tile = k6.q_tile_rows(S, H, B, n_sm)
            name += f" q_tile {tile}"
        if twice:
            same = torch.equal(out, k6.flash_attention_gqa(*args, **kwa))
            name += f" bit-identical over two launches {same}"
            self.ok &= same
        fn = (lambda: k6.flash_attention_gqa(*args, **kwa)) if timed else None
        window = kwa.get("window", 0)
        library = None
        if sdpa:
            library = (sdpa_window(q, k, v, pos, kpos, kwa["scale"], window) if window
                       else sdpa_causal(q, k, v, kwa["scale"]))
        self.report(name, out, ref, BF16_TOL if dtype == torch.bfloat16 else F32_TOL, fn,
                    library=library)

    def index_form(self, BH, S, T, dh):
        from repro_torch.kernels import flash_attention as k6

        q, k, v = (self.randn(BH, n, dh, dtype=torch.bfloat16) for n in (S, T, T))
        ipos = lambda n: torch.arange(n, dtype=torch.int32, device="cuda").expand(BH, n).contiguous()
        kw = dict(scale=1.0 / math.sqrt(dh), causal=True)
        out = k6.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = k6.flash_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None], ipos(S), ipos(T),
                                       **kw)[:, :, 0]
        self.report(f"kernel 6 bf16 index form BH {BH} S {S} T {T} dh {dh}", out, ref, BF16_TOL)

    def quant(self, B, T, filled, heads, dtype, kw=None, kpos=None, qpos=None, timed=False):
        """Kernel 9 over a contiguous int8 cache whose first ``filled`` slots
        of every row hold positions 0 .. filled - 1 (or ``kpos``), the query
        at filled - 1 (or ``qpos``)."""
        from repro_torch.kernels import attention_quant as k9
        from repro_torch.quant.kv import kv_quantize_values

        _, Hkv, dh = heads
        G = heads[0] // Hkv
        (kq, ks), (vq, vs) = (kv_quantize_values(self.randn(B, T, Hkv, dh, dtype=dtype))
                              for _ in range(2))
        if kpos is None:
            kpos = torch.full((B, T), -1, dtype=torch.int32, device="cuda")
            kpos[:, :filled] = torch.arange(filled, dtype=torch.int32, device="cuda")
        if qpos is None:
            qpos = torch.full((B,), filled - 1, dtype=torch.int32, device="cuda")
        args = (self.randn(B, Hkv, G, dh, dtype=dtype), kq, ks, vq, vs, kpos, qpos)
        kwa = dict(scale=1.0 / math.sqrt(dh), **(kw or {}))
        out = k9.decode_attention_quant(*args, **kwa)
        torch.cuda.synchronize()
        ref = k9.decode_attention_quant_plain(*args, **kwa)
        name = f"kernel 9 {str(dtype)[6:]} B {B} T {T} filled {filled} heads {heads} {kw or {}}"
        fn = (lambda: k9.decode_attention_quant(*args, **kwa)) if timed else None
        plain_mask = set(kw or {}) <= {"window"}
        lib = (sdpa_decode_quant(*args, kwa["scale"], window=kwa.get("window", 0))
               if timed and plain_mask else None)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        self.report(name, out, ref, tol, fn, library=lib)

    def ring(self, B, cap, heads, dtype, kw=None, holes=False, empty_row=None, timed=False):
        """Kernel 9 over a wrapped int8 ring of ``cap`` slots (``kw``: window
        = cap unless given): row b's newest key at position cap + 37 b + 11 in
        slot position % cap (the newest before the oldest in memory); the
        last row not yet wrapped, its slots past cap / 3 empty; ``holes``:
        every 7th slot empty; ``empty_row``: a row with no valid key, which
        must give 0."""
        qpos = torch.tensor([cap + 37 * b + 11 for b in range(B - 1)] + [cap // 3],
                            dtype=torch.int32, device="cuda")
        newest = qpos[:, None].long()
        slot = torch.arange(cap, device="cuda")[None]
        kpos = (newest - (newest % cap - slot) % cap).to(torch.int32)
        kpos[-1, cap // 3 + 1:] = -1
        if holes:
            kpos[:, 3::7] = -1
        if empty_row is not None:
            kpos[empty_row] = -1
        self.quant(B, cap, 0, heads, dtype, kw or dict(window=cap), kpos=kpos.contiguous(),
                   qpos=qpos, timed=timed)


# Patches for --variants: per source, per variant, (anchor, replacement)
# pairs applied to a copy of the source; each anchor must be found.
_NO_LOAD = ("""        mbar_expect_tx(&s.kfull[st], NC * BN * 128 + BN * 4);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(&s.k[st][c][0][0], &p.kmap, &s.kfull[st], c * 64, hk, j * BN, b);
        tma_load_1d(&s.kp[st][0], &p.pmap, &s.kfull[st], b * p.T + j * BN);
        stage_wait<DH>(&s.vempty[st], ph ^ 1u);
        mbar_expect_tx(&s.vfull[st], NC * BN * 128);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(&s.v[st][c][0][0], &p.vmap, &s.vfull[st], c * 64, hk, j * BN, b);""",
            """        mbar_arrive(&s.kfull[st]);
        stage_wait<DH>(&s.vempty[st], ph ^ 1u);
        mbar_arrive(&s.vfull[st]);""")
_NO_SOFTMAX = ("""      float alpha[2];
      tile_softmax(sc, p, s.kp[st], j * BN, all, qpr, cq, m, l, alpha);""",
               """      float alpha[2] = {1.f, 1.f};""")
_MARKS_FROM_POSITIONS = ("""  if (p.summ == nullptr) {  // a row of one tile: live, and masked per entry
    if (tid == 0) {
      s.live[0] = 1u;
      s.all[0] = 0u;
    }
    __syncthreads();
  } else {  // the row's tile summaries (a 64-key tile takes its 128-key
            // summary: live and full stay exact or err towards live and not
            // full, which the per-entry mask covers)
    const int4* summ = p.summ + (size_t)b * p.nS;
    for (int base = 0; base < nT; base += C::NT) {
      const int j = base + tid;
      bool live = false, all = false;
      if (j < nT) summary_marks(__ldg(summ + j * BN / WBN), s.qp_lo, s.qp_hi, p.mk.causal,
                                p.mk.window, live, all);
      const unsigned lb = __ballot_sync(0xffffffffu, live), ab = __ballot_sync(0xffffffffu, all);
      if (lane == 0 && base + warp * 32 < nT) {
        s.live[(base >> 5) + warp] = lb;
        s.all[(base >> 5) + warp] = ab;
      }
    }
    __syncthreads();
  }

""", """  mark_tiles<BN, 32>(p.kpos + (size_t)b * p.T, p.T, s.qp_lo, s.qp_hi, p.mk.causal, p.mk.window,
                     s.live, s.all, C::WORDS);

""")
_NO_SCAN = ("""p.G, __ldg(p.qpos + b), p.mk, true,""", """p.G, __ldg(p.qpos + b), p.mk, false,""")
VARIANTS = {
    "flash_attention": {"kernel": [], "no_load": [_NO_LOAD], "no_softmax": [_NO_SOFTMAX],
                        "no_load_no_softmax": [_NO_LOAD, _NO_SOFTMAX],
                        "marks_from_positions": [_MARKS_FROM_POSITIONS]},
    "decode_attention_quant": {"kernel": [], "no_scan": [_NO_SCAN]},
}


def build_variants() -> dict:
    """Every patched copy of VARIANTS built at once: {(source, variant): CDLL}."""
    import ctypes
    import shutil
    import subprocess

    from repro_torch.kernels import build

    root = build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build.CSRC, root / "csrc")
    procs = {}
    for source, variants in VARIANTS.items():
        src = (build.CSRC / f"{source}.cu").read_text()
        for name, patches in variants.items():
            text = src
            for anchor, repl in patches:
                if anchor not in text:
                    raise RuntimeError(f"variant {name}: anchor not found in {source}.cu")
                text = text.replace(anchor, repl)
            stem = f"{source}_{name}"
            (root / "csrc" / f"{stem}.cu").write_text(text)
            procs[source, name] = subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(root / f"lib{stem}.so"),
                 str(root / "csrc" / f"{stem}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    for (source, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {source} {name} failed to build:\n{log}")
    return {key: ctypes.CDLL(str(root / f"lib{key[0]}_{key[1]}.so")) for key in procs}


def time_variants(source, libs, cases):
    """Each variant of ``source`` swapped in for the wrapper's library and
    timed on each of ``cases`` ({label: call}) from CUDA graphs and on the
    host (``host_ms`` over 200 calls), in turns (every variant twice, in
    opposite orders)."""
    from repro_torch.kernels import build

    names = list(VARIANTS[source])
    loaded = build._loaded.get(source)
    try:
        for name in names + names[::-1]:
            build._loaded[source] = libs[source, name]
            for label, call in cases.items():
                print(f"{source} variant {name}: {label}: {graph_ms(call, n=10):.4f} ms, host "
                      f"{host_ms(call, n=200):.4f} ms", flush=True)
    finally:
        if loaded is None:
            build._loaded.pop(source, None)
        else:
            build._loaded[source] = loaded


def variant_cases(gen):
    """The timed calls of --variants: kernel 6 at the served 4 x 64 prefill
    (llama4's and glm4's heads), at 16384 and 1024 causal tokens of llama4's
    heads and at 4096 of nlg's; kernel 9 at its timed shapes (llama4's
    heads)."""
    from repro_torch.kernels import attention_quant as k9
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.quant.kv import kv_quantize_values

    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
    flash = {}
    for B, S, heads in ((4, 64, LLAMA4), (4, 64, GLM4), (1, 16384, LLAMA4), (1, 1024, LLAMA4),
                        (1, 4096, NLG)):
        H, Hkv, dh = heads
        q, k, v = randn(B, S, H, dh), randn(B, S, Hkv, dh), randn(B, S, Hkv, dh)
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S).contiguous()
        flash[f"B {B} S {S} heads {heads}"] = (
            lambda a=(q, k, v, pos, pos), sc=1 / math.sqrt(dh): k6.flash_attention_gqa(*a, scale=sc))
    quant = {}
    H, Hkv, dh = LLAMA4
    for B, T, filled in ((4, 80, 65), (4, 2112, 80), (8, 2048, 1024), (2, 16392, 8)):
        (kq, ks), (vq, vs) = (kv_quantize_values(randn(B, T, Hkv, dh)) for _ in range(2))
        kpos = torch.full((B, T), -1, dtype=torch.int32, device="cuda")
        kpos[:, :filled] = torch.arange(filled, dtype=torch.int32, device="cuda")
        qpos = torch.full((B,), filled - 1, dtype=torch.int32, device="cuda")
        args = (randn(B, Hkv, H // Hkv, dh), kq, ks, vq, vs, kpos, qpos)
        quant[f"B {B} T {T} filled {filled}"] = (
            lambda a=args: k9.decode_attention_quant(*a, scale=1 / math.sqrt(dh)))
    return {"flash_attention": flash, "decode_attention_quant": quant}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long-only", action="store_true",
                    help="only the timed long cases (kernel 6 at 16384 tokens and at "
                    "recurrentgemma's prefill, kernel 9 at 8 x 2048)")
    ap.add_argument("--variants", action="store_true",
                    help="also time kernel 6 built without its loads / softmax (what bounds it) "
                    "and kernel 9 without its position scan")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["flash_attention", "decode_attention_quant"])
    print(f"build {time.perf_counter() - t0:.1f} s; {torch.cuda.get_device_name(0)}", flush=True)
    c = Attn()
    bf, f32 = torch.bfloat16, torch.float32
    ws = dict(window=37, softcap=20.0)
    if not args.long_only:
        for heads in (LLAMA4, GLM4, NLG):  # the static serves' prefill
            c.flash(4, 64, heads, bf, timed=True, sdpa=True)
        for heads in ((4, 2, 128), (4, 2, 64), (4, 2, 32), (4, 2, 112), RGEMMA):
            for dt in (bf, f32):
                c.flash(3, 300, heads, dt, ws, offsets=[5, 400, 0], holes=True, zero_row=2)
            c.flash(2, 4500, heads, bf, dict(window=1500, softcap=20.0), offsets=[0, 37], holes=True)
            c.flash(2, 4500, heads, bf, offsets=[0, 37], holes=True)
        c.flash(1, 1000, GLM4, bf)
        c.flash(2, 64, LLAMA4, bf, offsets=[0, 3], holes=True)  # 64-row tiles: 64-key tiles
        c.flash(1, 40, NLG, bf, dict(window=9, softcap=20.0), holes=True)
        c.flash(2, 2100, LLAMA4, bf)
        c.index_form(40, 128, 384, 128)
        c.index_form(16, 200, 200, 64)
        c.quant(4, 80, 65, LLAMA4, bf, timed=True)  # the served static cache
        c.quant(4, 2112, 80, LLAMA4, bf, timed=True)  # sized for 2048 new tokens, first step
        c.quant(4, 80, 65, LLAMA4, f32)
        c.quant(2, 16392, 8, LLAMA4, bf, timed=True)  # a long cache, 8 keys filled
        c.quant(3, 300, 50, GLM4, bf)
        c.quant(3, 300, 50, NLG, bf)
        c.quant(3, 80, 80, (4, 2, 32), bf, ws)
        ring = torch.roll(torch.arange(1000, 1300, dtype=torch.int32, device="cuda"), 123)
        kpos = torch.stack([ring, torch.full_like(ring, -1), ring]).contiguous()  # row 1: no key
        qpos = torch.tensor([1299, 5, 1250], dtype=torch.int32, device="cuda")
        for dt in (bf, f32):
            c.quant(3, 300, 0, LLAMA4, dt, dict(window=200, softcap=20.0), kpos=kpos, qpos=qpos)
            c.ring(3, 300, RGEMMA, dt, ws, holes=True, empty_row=1)
        c.ring(72, 300, RGEMMA, bf, dict(softcap=20.0, window=300), holes=True, empty_row=5)
        c.flash(4, 2048, GEMMA3, bf, dict(window=1024), timed=True, sdpa=True)
        c.ring(8, 1024, GEMMA3, bf, timed=True)
    c.quant(8, 2048, 1024, LLAMA4, bf, timed=True)
    c.flash(1, 16384, LLAMA4, bf, timed=True, sdpa=True)
    c.flash(1, 4096, NLG, bf, timed=True, sdpa=True)
    for B, S in ((1, 4096), (4, 1500)):  # recurrentgemma's prefill
        c.flash(B, S, RGEMMA, bf, dict(window=2048), timed=True, sdpa=True, twice=True)
    c.ring(8, 2048, RGEMMA, bf, timed=True)
    if args.variants:
        libs = build_variants()
        for source, cases in variant_cases(torch.Generator(device="cuda").manual_seed(1)).items():
            time_variants(source, libs, cases)
    print("all cases agree" if c.ok else "SOME CASES DISAGREE", flush=True)
    return 0 if c.ok else 1


if __name__ == "__main__":
    sys.exit(main())
