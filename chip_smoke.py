"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

  python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. card: name and power limit (nvidia-smi); TF32 off for the f32 checks.
2. build: every kernel of the port, compiled with nvcc from the checkout.
3. serve: llama4-maverick-400b-a17b at full width (d_model 5120, 128
   experts of d_ff 8192, vocab 202048), depth cut to one repeat of its
   (dense, MoE) pattern, bf16 random weights drawn on the card from a seed,
   ``moe_impl="grouped"``.  The port's ``Engine`` serves 4 requests (prompt
   64, 16 new tokens, greedy); the kernels' launch counts are set to 0 just
   before and read just after.  A torch.profiler account of 5 decode steps
   (kernels' device time, host operators, launches, syncs, idle share).
   Then a small-input reference: reduced
   llama4 in f32 served on the card (kernels) and on the CPU (plain
   versions) from the same weights must agree.
4. kernels: each kernel against its plain PyTorch version on the same inputs
   at the main path's shapes (the served MoE layer's weights, a routing of
   random tokens by its router, T = 256 as in prefill and T = 4 as in
   decode), in bf16, and once in f32 on a reduced config; then timed with
   CUDA events (calls back to back, see ``time_ms``) beside its bound.
5. a ``{"kernels": [...]}`` line, the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ARCH = "llama4-maverick-400b-a17b"
BATCH, PROMPT, NEW = 4, 64, 16
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# bf16 check: kernel and plain version sum in different orders in f32, so
# the activation and the output may round to neighbouring bf16 values: one
# ulp of the output is 2^-7 of its magnitude at most; allow two, relative to
# the largest output.  f32 check: only the summation order differs.
BF16_TOL = 2e-2
F32_TOL = 1e-5


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n=10, reps=5, warmup=3) -> float:
    """Device time of one call of ``fn``, CUDA events: ``n`` calls issued back
    to back between two events, so the card never waits for the host's
    per-call work; the median over ``reps`` such windows, divided by ``n``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def grouped_case(moe, T, K, gen, dtype):
    """Inputs of the grouped MLP as the MoE layer builds them: T random
    tokens routed by the layer's router, sorted into the tile-padded buffer."""
    from repro_torch.core.dispatch_grouped import grouped_layout
    from repro_torch.core.gating import top_k_gating

    E, D, F = moe["wi"].shape
    x = torch.randn((T, D), generator=gen, device="cuda").to(dtype)
    g = top_k_gating(x.float() @ moe["router"], K, T * K)
    lay = grouped_layout(g, E)
    Ct = lay.tile_expert.shape[0] * 8
    xg = torch.zeros((Ct, D), dtype=dtype, device="cuda")
    xg[lay.dst] = x[torch.arange(T * K, device="cuda") // K]
    rows = int(lay.rows_used.item())
    live = lay.tile_expert[: rows // 8]
    n_experts = int(torch.unique(live).numel())
    b = torch.tensor([], dtype=dtype).element_size()
    # the weights of the experts the live tiles touch, the live input rows and
    # their tile -> expert entries, rows_used, and the whole [Ct, D] output
    # (dead rows are zeros the function returns); tiles past rows_used read
    # nothing else
    need_bytes = n_experts * 3 * D * F * b + (rows + Ct) * D * b + (rows // 8 + 1) * 4
    ops = 2 * T * K * 3 * D * F
    bound_s = max(need_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])
    info = {"T": T, "K": K, "Ct": Ct, "rows_used": rows, "distinct_experts": n_experts,
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if need_bytes / HBM_BYTES_PER_S >= ops / PEAK_OPS[dtype] else "operations"}
    args = (xg, lay.tile_expert, moe["wi"], moe["wg"], moe["wo"], lay.rows_used)
    return args, info


def check_kernel(args, tol):
    from repro_torch.kernels import expert_mlp_grouped as gk

    out = gk.grouped_mlp(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = gk.grouped_mlp_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert out.shape == plain.shape and torch.isfinite(out.float()).all()
    err = (out.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    if rel > tol:
        raise AssertionError(f"grouped_mlp disagrees with its plain version: max|d|={err:.3e}, "
                             f"max|plain|={scale:.3e}, rel {rel:.3e} > {tol}")
    return {"max_abs_err": err, "max_rel_err": rel, "plain_ms": plain_ms}


def reference_check(cfg) -> str:
    """The main path on a small input against a reference: the same f32
    weights served on the card (through the kernels) and on the CPU (through
    their plain versions) give the same logits within 1e-4 (f32, TF32 off;
    only summation order differs) and the same greedy tokens."""
    import copy

    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    on_card = init_params(cfg, seed=SEED, device="cuda")
    on_cpu = copy.deepcopy(on_card).to("cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 12), generator=torch.Generator().manual_seed(SEED))
    a, _ = forward(cfg, on_card, toks.cuda())
    b, _ = forward(cfg, on_cpu, toks)
    assert a.shape == b.shape and torch.isfinite(a).all()
    err = (a.cpu() - b).abs().max().item()
    if not torch.allclose(a.cpu(), b, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"reduced {cfg.name}: card logits differ from the CPU's by {err:.3e}")
    ec = EngineConfig(max_batch=4, max_prefill=12, max_decode=8)
    reqs = [Request(toks[i, : 12 - 3 * i].tolist(), 8) for i in range(3)]
    card = [r.tokens for r in Engine(cfg, on_card, ec, device="cuda").generate(reqs)]
    cpu = [r.tokens for r in Engine(cfg, on_cpu, ec, device="cpu").generate(reqs)]
    if card != cpu:
        raise AssertionError(f"reduced {cfg.name}: greedy tokens on the card {card} != CPU {cpu}")
    return (f"reference: reduced {cfg.name} f32, card (kernels) vs CPU (plain versions): "
            f"logits max|d| {err:.3e} (tolerance 1e-4), greedy tokens identical {card}")


def profile_decode(eng, cfg, params, steps=5) -> list:
    """Where a decode step's time goes (torch.profiler): wall time per step,
    device time of the kernels (by name), host time of the operators, and the
    host syncs, as the engine runs the step (greedy token read back).  The
    same steps run once more without the profiler, so the idle share can be
    given both as measured under the profiler and as derived from the
    profiled kernel time over the unprofiled wall time of this run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import decode_step, prefill

    def run_steps(prof=None):
        caches = eng._make_caches(BATCH)
        logits, caches = prefill(cfg, params, toks, caches)
        cur = logits.argmax(-1)[:, None]
        cur.cpu()
        with prof or contextlib.nullcontext():
            t0 = time.perf_counter()
            for t in range(steps):
                logits, caches = decode_step(cfg, params, cur, PROMPT + t, caches)
                cur = logits.argmax(-1)[:, None]
                cur.cpu()
            return (time.perf_counter() - t0) / steps * 1e3

    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device="cuda")
    plain_wall = run_steps()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = run_steps(prof)
    evs = prof.key_averages()
    kern = sorted(((ev.self_device_time_total, ev.key) for ev in evs
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0), reverse=True)
    host = sorted(((ev.self_cpu_time_total, ev.key, ev.count) for ev in evs
                   if ev.device_type == DeviceType.CPU), reverse=True)
    syncs = sum(ev.count for ev in evs if ev.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                                                       "cudaDeviceSynchronize"))
    n_launch = sum(ev.count for ev in evs if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    if not kern:
        return ["decode profile: the profiler recorded no device time (not measured)"]
    dev = sum(d for d, _ in kern) / steps / 1e3
    per = lambda d: f"{d / steps / 1e3:.3f} ms"
    return [
        f"decode profile: kernels {dev:.3f} device ms/step; wall {wall:.3f} ms/step with the "
        f"profiler on (device idle {100 * (1 - dev / wall):.1f}%, measured), {plain_wall:.3f} ms/step "
        f"with it off (device idle {100 * (1 - dev / plain_wall):.1f}%, derived: profiled kernel "
        f"time over unprofiled wall time); {n_launch / steps:.0f} kernel launches and "
        f"{syncs / steps:.1f} host syncs per step",
        "decode profile, kernels: " + "; ".join(f"{k[:70]} {per(d)}" for d, k in kern[:8]),
        "decode profile, host ops (self CPU): " + "; ".join(
            f"{k} {per(d)} x{c // steps}" for d, k, c in host[:10]),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.kernels import build
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    # 1. card
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"build: {len(build.sources())} source(s) ready in {time.perf_counter() - t0:.2f} s "
        f"(compiled: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items()) or 'none'})")
    for src in build.sources():
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    # 3. serve at full width, depth cut to one (dense, MoE) repeat
    full = get_config(ARCH)
    cfg = full.replace(moe_impl="grouped", segments=(Segment(full.segments[0].pattern, 1),))
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(b.numel() for b in params.buffers())
    log(f"init: {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} layers, "
        f"{n_params / 1e9:.2f} G parameters ({torch.cuda.memory_allocated() / 1e9:.1f} GB) "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    eng = Engine(cfg, params, EngineConfig(max_batch=BATCH, max_prefill=PROMPT, max_decode=NEW),
                 device="cuda")
    rng = torch.Generator().manual_seed(SEED)
    reqs = [Request(torch.randint(0, cfg.vocab_size, (PROMPT,), generator=rng).tolist(), NEW)
            for _ in range(BATCH)]
    eng.generate(reqs)  # warm-up: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    for k in gk.launches:
        gk.launches[k] = 0
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    wall = time.perf_counter() - t0
    launches = dict(gk.launches)
    assert len(out) == BATCH and all(len(r.tokens) == NEW for r in out), [r.tokens for r in out]
    assert all(0 <= tok < cfg.vocab_size for r in out for tok in r.tokens)
    n_moe = sum(ls.ffn.kind == "moe" for ls in cfg.layer_specs())
    expected = n_moe * (1 + NEW - 1)
    if launches["grouped_mlp"] != expected:
        raise AssertionError(f"grouped_mlp launched {launches['grouped_mlp']} times, expected {expected}")
    tm = eng.last_timings
    step_ms = statistics.median(tm["decode_step_s"]) * 1e3
    log(f"serve: {BATCH} requests x {NEW} tokens in {wall * 1e3:.3f} ms "
        f"({BATCH * NEW / wall:.1f} tok/s); prefill {tm['prefill_s'] * 1e3:.3f} ms "
        f"(batch {BATCH} x {PROMPT}); decode step median {step_ms:.3f} ms "
        f"({BATCH / step_ms * 1e3:.1f} tok/s) over {len(tm['decode_step_s'])} steps; "
        f"launches {launches}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    log(f"serve: tokens of request 0: {out[0].tokens}")
    for line in profile_decode(eng, cfg, params):
        log(line)
    log(reference_check(make_reduced(full).replace(moe_impl="grouped")))

    # 4. kernels against their plain versions, then timed beside their bounds
    moe = {k: v[0] for k, v in params["segments"]["seg0"]["pos1"]["moe"].items() if torch.is_tensor(v)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shapes = {}
    for label, T in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        kargs, info = grouped_case(moe, T, 1, gen, torch.bfloat16)
        info.update(check_kernel(kargs, BF16_TOL))
        info["ms"] = time_ms(lambda: gk.grouped_mlp(*kargs))
        shapes[label] = info
        log(f"kernel grouped_mlp bf16 {label}: {json.dumps(info)}")
    red = make_reduced(full).replace(moe_impl="grouped")
    rp = init_params(red, seed=SEED, device="cuda")
    rmoe = {k: v[0] for k, v in rp["segments"]["seg0"]["pos1"]["moe"].items() if torch.is_tensor(v)}
    kargs, info = grouped_case(rmoe, 64, 1, gen, torch.float32)
    info.update(check_kernel(kargs, F32_TOL))
    shapes["f32_reduced"] = info
    log(f"kernel grouped_mlp f32 reduced: {json.dumps(info)}")

    dec = shapes["decode"]
    kernels = [{
        "name": "grouped_mlp",
        "route": "cuda",
        "source": "src/repro_torch/csrc/grouped_mlp.cu",
        "replaces": "src/repro/kernels/expert_mlp_grouped.py:88",
        "launches": launches["grouped_mlp"],
        "max_abs_err": max(shapes[s]["max_abs_err"] for s in ("prefill", "decode")),
        "max_rel_err": max(shapes[s]["max_rel_err"] for s in ("prefill", "decode")),
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a grouped SwiGLU MLP
        "shapes": shapes,
    }]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
