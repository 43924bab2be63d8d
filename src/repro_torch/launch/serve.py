"""Serving launcher of the port: randomly initialises (or loads) a model and
serves synthetic requests through the static batched engine, reporting
prefill and per-step decode latency, or with ``--paged`` through the
continuous-batching engine over a paged KV pool, reporting its per-tick
numbers: ``--prefill-mode chunked|batched|scatter`` picks its admission
prefill, ``--prefix-sharing`` shares prompt pages with copy-on-write,
``--n-samples N`` serves N parallel samples of each prompt, and
``--spec-draft ARCH|self --spec-k K`` decodes speculatively (greedy only).
Either engine runs under ``repro_torch.obs.Obs``: the measured run's
metrics (reset after the warm-up) are printed from one snapshot, which
``--metrics-out FILE`` appends as a JSON line; ``--trace-out FILE`` writes
the Chrome / Perfetto trace of the run and ``--obs-routing`` adds the
per-step routing statistics (the ``routing.*`` gauges).  ``--ep-devices 4``
or ``2x2`` serves expert-parallel (serving/ep.py): one spawned process per
rank, each with its slice of the experts, over gloo with ``--device cpu``
and over NCCL with one GPU per rank on the card (it refuses to start with
fewer GPUs than ranks); rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b \\
      --reduced                                 # on the card, the arch's own moe_impl
  ... --device cpu                              # on the CPU (plain versions)
  ... --moe-impl grouped                        # dropless grouped dispatch instead
  PYTHONPATH=src python -m repro_torch.launch.serve --arch nlg-350m-moe128 --reduced
  ... --paged --page-size 16 --pages 64 --slots 4 --prefill-chunk 32 --device cpu
  ... --paged --prefix-sharing --n-samples 2 --prefill-mode batched
  ... --paged --spec-draft self --spec-k 3    # or a registry arch as the drafter
  ... --quant-bits 8 --quant-policy experts --kv-bits 8   # MoQ weights, int8 KV cache
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b --reduced
  ... --arch recurrentgemma-2b | mamba2-370m     # window rings, RG-LRU, Mamba-2 SSD
  ... --paged --spec-draft self                  # any of them as target or drafter
  ... --trace-out trace.json --metrics-out metrics.jsonl --obs-routing
  ... --ep-devices 2x2 --device cpu             # 4 gloo ranks, hierarchical a2a

A subset of ``repro.launch.serve``'s flags.  An encoder-decoder arch
(seamless-m4t-medium) exits with an error: the launcher has no encoder
input to give it (``Engine(memory=encode(...))`` serves it from Python); a
vlm arch serves text tokens without patch embeddings, as the JAX launcher
does.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.models.model import init_caches, init_paged_caches, init_params
from repro_torch.obs import Obs
from repro_torch.quant import kv_cache_bytes, quantize_params, quantized_leaf_paths, tree_bytes
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request
from repro_torch.serving.ep import launch, mesh_size, parse_ep_mesh, placed_param_bytes


def parse(argv=None):
    """(args, cfg) from the command line, checked; ``cfg.ep_mesh`` set from
    ``--ep-devices``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory in the JAX package's format")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "einsum", "dense", "ep", "grouped"],
                    help="MoE dispatch override (default: the arch's own); 'grouped' is "
                         "the dropless expert-sorted path (no expert_capacity, no drops), "
                         "'ep' without a mesh is 'dense'")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the continuous-batching engine over a paged KV "
                         "pool (admission by free-block count, chunked prefill)")
    ap.add_argument("--page-size", type=int, default=16, help="cache tokens per page for --paged")
    ap.add_argument("--pages", type=int, default=0,
                    help="pool pages for --paged (0 = slots * ceil(capacity / page_size))")
    ap.add_argument("--slots", type=int, default=0, help="decode slots for --paged (default --batch)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="with --paged: prefill tokens per engine tick (0 = max(64, page size))")
    ap.add_argument("--quant-bits", type=int, default=0, choices=[0, 4, 8],
                    help="weight-only PTQ before serving (0 = off; MoQ)")
    ap.add_argument("--quant-policy", default="experts",
                    choices=["experts", "experts_attn", "all"])
    ap.add_argument("--quant-group-size", type=int, default=0,
                    help="scale group size along the contraction dim, int8 or int4 "
                         "(0 = one scale per output channel)")
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 8],
                    help="KV-cache quantization: 8 = int8 cache with per-head, per-timestep "
                         "scales, 0 = full precision")
    ap.add_argument("--prefill-mode", default="chunked", choices=["chunked", "batched", "scatter"],
                    help="with --paged: 'chunked' prefills one slot's chunks per tick "
                         "(default), 'batched' advances every prefilling slot one chunk in "
                         "one call per tick, 'scatter' prefills a whole context at admission "
                         "(the parity oracle)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="with --paged: contexts repeating an indexed full-page prefix share "
                         "its pages (refcounted, copy-on-write) and skip its prefill")
    ap.add_argument("--n-samples", type=int, default=1,
                    help="parallel samples per prompt (paged engine); with --prefix-sharing "
                         "they share all prompt pages and diverge by copy-on-write")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH",
                    help="draft-then-verify speculative decoding: registry arch of the drafter "
                         "(random weights from seed 1, --reduced applies) or 'self' for the "
                         "target as its own drafter; greedy only, needs --paged")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="with --spec-draft: drafted tokens per verify window")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the run's Chrome / Perfetto trace (request, slot and engine "
                         "tracks) to FILE; load it in ui.perfetto.dev")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="append the run's metrics snapshot to FILE as one JSON line")
    ap.add_argument("--obs-routing", action="store_true",
                    help="collect per-step routing statistics (routing.* gauges: dropped "
                         "share, gate entropy, imbalance)")
    ap.add_argument("--ep-devices", default=None, metavar="N[xM]",
                    help="expert-parallel serving mesh: '4' shards the experts flat over 4 "
                         "ranks, '2x2' builds an (outer, inner) mesh whose MoE exchange is the "
                         "hierarchical two-hop all-to-all (paper Fig. 8); one process per rank, "
                         "gloo with --device cpu, NCCL with one GPU per rank on the card")
    args = ap.parse_args(argv)
    if (args.prefill_chunk or args.slots or args.pages) and not args.paged:
        ap.error("--pages/--slots/--prefill-chunk apply to the paged engine; pass --paged")
    if args.prefix_sharing and not args.paged:
        ap.error("--prefix-sharing requires --paged (block tables)")
    if args.prefill_mode != "chunked" and not args.paged:
        ap.error(f"--prefill-mode {args.prefill_mode} is an admission policy of the paged "
                 "continuous engine; pass --paged")
    if args.n_samples > 1 and not args.paged:
        ap.error("--n-samples > 1 is served by the paged continuous engine; pass --paged")
    if args.n_samples < 1:
        ap.error(f"--n-samples must be >= 1, got {args.n_samples}")
    if args.paged and args.prefill_chunk and args.prefill_chunk < args.page_size:
        ap.error(f"--prefill-chunk {args.prefill_chunk} must be >= --page-size "
                 f"{args.page_size} (chunk boundaries are page-aligned)")
    if args.temperature <= 0.0 and (args.top_k or args.top_p):
        ap.error("--top-k/--top-p have no effect at --temperature 0 (greedy); "
                 "pass --temperature > 0")
    if args.spec_draft:
        if not args.paged:
            ap.error("--spec-draft rides the paged continuous engine (CoW page forks); "
                     "pass --paged")
        if args.temperature > 0.0:
            ap.error("--spec-draft is greedy-only: verification accepts the longest draft "
                     "prefix matching the target's argmax, which is exact only at "
                     "--temperature 0")
        if args.spec_k < 1:
            ap.error(f"--spec-k must be >= 1, got {args.spec_k}")
        if args.obs_routing:
            ap.error("--obs-routing is incompatible with --spec-draft: the verify pass "
                     "returns no routing statistics")
        if args.ep_devices:
            ap.error("--spec-draft is not implemented over an expert-parallel serving mesh; "
                     "drop --ep-devices")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if cfg.encoder is not None:
        ap.error(f"--arch {cfg.name} is an encoder-decoder model: the launcher has no encoder "
                 "input for it; serve it through Engine(memory=encode(...))")
    if args.top_k > cfg.vocab_size:
        ap.error(f"--top-k {args.top_k} exceeds vocab_size {cfg.vocab_size}")
    if args.moe_impl:
        has_moe = any(ls.ffn.num_experts for seg in cfg.segments for ls in seg.pattern)
        if args.moe_impl == "grouped" and not has_moe:
            ap.error(f"--moe-impl grouped: arch '{cfg.name}' has no MoE "
                     "layers to dispatch — pick an MoE arch (e.g. "
                     "nlg-350m-moe128) or drop the flag")
        cfg = cfg.replace(moe_impl=args.moe_impl)
    if args.spec_draft and args.spec_draft != "self":
        dcfg = drafter_config(args)
        if dcfg.vocab_size != cfg.vocab_size:
            ap.error(f"--spec-draft {args.spec_draft}: drafter vocab {dcfg.vocab_size} != target "
                     f"vocab {cfg.vocab_size}; greedy verification needs a shared token space")
    if args.ep_devices:
        try:
            shape = parse_ep_mesh(args.ep_devices)
        except ValueError as e:
            ap.error(str(e))
        world = mesh_size(shape)
        if args.device != "cpu" and world > torch.cuda.device_count():
            ap.error(f"--ep-devices {args.ep_devices}: needs {world} GPUs, one per rank, "
                     f"only {torch.cuda.device_count()} visible (--device cpu serves on gloo "
                     "ranks)")
        cfg = cfg.replace(ep_mesh=shape)
    return args, cfg


def drafter_config(args):
    """The config of ``--spec-draft ARCH`` (``--reduced`` applies)."""
    dcfg = get_config(args.spec_draft)
    return make_reduced(dcfg) if args.reduced else dcfg


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args, cfg = parse(argv)
    world = mesh_size(cfg.ep_mesh)
    if world > 1:
        launch(serve_rank, world, backend="gloo" if args.device == "cpu" else "nccl",
               args=(argv,), threads=max(1, torch.get_num_threads() // world))
        return
    serve(args, cfg)


def serve_rank(rank: int, argv) -> None:
    """One rank of ``--ep-devices``: the same serve as every other rank, its
    output printed by rank 0 only."""
    args, cfg = parse(argv)
    if rank == 0:
        serve(args, cfg)
        return
    args.trace_out = args.metrics_out = None  # rank 0 writes them
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        serve(args, cfg)


def print_mesh(eng) -> None:
    """The JAX launcher's line for a mesh: its axes, the EP schedule and this
    rank's parameter bytes."""
    if eng._mesh is not None:
        print(f"EP serving mesh {eng._mesh.sizes()} ({eng._mesh.backend}): "
              f"moe_impl={eng.cfg.moe_impl}, {placed_param_bytes(eng.params) / 1e6:.1f}MB "
              "params/rank")


def serve(args, cfg) -> None:
    params = load_params(args, cfg)
    obs = Obs(trace=bool(args.trace_out), routing=args.obs_routing)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist(),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    if args.paged:
        spec_draft = None
        if args.spec_draft == "self":
            spec_draft = (cfg, params)
        elif args.spec_draft:
            dcfg = drafter_config(args)
            spec_draft = (dcfg, init_params(dcfg, seed=1, device=args.device))
        serve_paged(args, cfg, params, reqs, obs, spec_draft)
        return
    ec = EngineConfig(max_batch=args.batch, max_prefill=args.prompt_len,
                      max_decode=args.new_tokens, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p, kv_cache_bits=args.kv_bits)
    eng = Engine(cfg, params, ec, obs=obs, device=args.device)
    del params  # an EP rank keeps its own slice only
    print_mesh(eng)
    if args.kv_bits:
        fp_b, q_b = (kv_cache_bytes(init_caches(cfg, args.batch, eng._capacity, kv_bits=b,
                                                device="meta")) for b in (0, args.kv_bits))
        print(f"KV cache int{args.kv_bits}: {fp_b / 1e6:.2f}MB -> {q_b / 1e6:.2f}MB "
              f"({fp_b / q_b:.2f}x fewer cache bytes)")
    eng.generate(reqs[: args.batch])  # warm-up: builds the kernels on the card
    obs.metrics.reset_all()  # the warm-up's samples leave the window
    t0 = time.perf_counter()
    responses = eng.generate(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in responses)
    print(f"served {len(responses)} requests, {n_tok} tokens in {dt:.3f}s "
          f"({n_tok / dt:.1f} tok/s, arch={cfg.name}, moe_impl={cfg.moe_impl}, "
          f"device={eng.device})")
    tm = eng.last_timings
    steps = tm["decode_step_s"]
    print(f"  last batch: prefill {tm['prefill_s'] * 1e3:.3f} ms "
          f"(batch {tm['batch']} x {tm['prompt_len']}), decode step median "
          f"{(statistics.median(steps) * 1e3) if steps else float('nan'):.3f} ms "
          f"over {len(steps)} steps")
    report_obs(args, obs, cfg, dict(paged=False, requests=len(responses), tokens=n_tok, wall_s=dt))
    print("sample:", responses[0].tokens[:10])


def report_obs(args, obs, cfg, extra: dict) -> None:
    """The run's metrics from ONE snapshot (printed, and appended to
    ``--metrics-out``), and the trace to ``--trace-out``."""
    print(obs.metrics.render(prefix="  "))
    if args.metrics_out:
        obs.metrics.write_jsonl(args.metrics_out, extra={"arch": cfg.name, **extra})
        print(f"metrics snapshot -> {args.metrics_out}")
    if args.trace_out:
        n = obs.tracer.export(args.trace_out)
        print(f"trace ({n} events) -> {args.trace_out}; load in https://ui.perfetto.dev")


def load_params(args, cfg):
    """Random weights from seed 0 or ``--ckpt``, then PTQ per ``--quant-*``.
    A checkpoint may hold a tree that was quantized with the same flags or a
    full-precision one to quantize after loading, as in the JAX launcher."""
    from repro_torch.convert import load_checkpoint

    if not args.quant_bits:
        if args.ckpt:
            return load_checkpoint(args.ckpt, cfg, args.device)
        return init_params(cfg, seed=0, device=args.device)
    qcfg = QuantConfig(bits=args.quant_bits, group_size=args.quant_group_size,
                       policy=args.quant_policy)
    params = None
    if args.ckpt:
        try:
            params = load_checkpoint(args.ckpt, cfg, args.device, qcfg=qcfg)
        except ValueError as q_err:
            try:
                fp = load_checkpoint(args.ckpt, cfg, args.device)
            except ValueError as fp_err:
                raise ValueError(
                    f"--ckpt {args.ckpt!r} matches neither the quantized structure for {qcfg} "
                    f"({q_err}) nor the fp structure ({fp_err})") from fp_err
    else:
        fp = init_params(cfg, seed=0, device=args.device)
    if params is None:
        fp_bytes = tree_bytes(fp)
        params = quantize_params(fp, qcfg)
        print(f"PTQ int{args.quant_bits}/{args.quant_policy}: {fp_bytes / 1e6:.1f}MB -> "
              f"{tree_bytes(params) / 1e6:.1f}MB")
    if not quantized_leaf_paths(params):
        print(f"WARNING: quant policy '{args.quant_policy}' matched no weights in {cfg.name} "
              "- serving full precision")
    if args.quant_group_size:
        print(f"NB: the grouped expert kernel takes per-output-channel scales; group_size="
              f"{args.quant_group_size} experts take the plain dequantize path")
    return params


def serve_paged(args, cfg, params, reqs, obs, spec_draft=None) -> None:
    eng = ContinuousEngine(
        cfg, params, slots=args.slots or args.batch, capacity=args.prompt_len + args.new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, paged=True,
        page_size=args.page_size, n_pages=args.pages, prefill_chunk=args.prefill_chunk,
        prefill_mode=args.prefill_mode, prefix_sharing=args.prefix_sharing,
        kv_cache_bits=args.kv_bits, spec_draft=spec_draft, spec_k=args.spec_k, obs=obs,
        device=args.device)
    print_mesh(eng)
    if spec_draft is not None:
        print(f"speculative decoding: drafter={spec_draft[0].name}"
              f"{' (self)' if args.spec_draft == 'self' else ''}, k={args.spec_k} drafted tokens "
              "per verify window")
    pool_b = kv_cache_bytes(init_paged_caches(cfg, eng.n_slots, eng.capacity, n_pages=eng.n_pages,
                                              page_size=eng.page_size, kv_bits=args.kv_bits,
                                              device="meta"))
    print(f"paged pool: {eng.n_pages} pages x {eng.page_size} tokens ({pool_b / 1e6:.2f}MB, "
          f"kv_bits {args.kv_bits}), {eng.n_slots} slots, capacity {eng.capacity}, prefill "
          f"chunk {eng.prefill_chunk}")
    # warm-up: builds the kernels on the card; the request completes, so the
    # pool starts the timed run empty
    eng.submit(Request(prompt=reqs[0].prompt, max_new_tokens=2))
    eng.run_until_done()
    eng.done.clear()
    eng.metrics_log.clear()
    eng.preemptions = eng.prefill_tokens_total = eng.prefill_tokens_skipped = 0
    eng.prefix_hits = eng.prefix_hit_tokens = eng.cow_copies = 0
    obs.metrics.reset_all()  # the warm-up's samples leave the window
    t0 = time.perf_counter()
    if args.n_samples > 1:
        ids = [rid for r in reqs for rid in eng.submit_n(r, args.n_samples)]
    else:
        ids = [eng.submit(r) for r in reqs]
    done = eng.run_until_done()
    dt = time.perf_counter() - t0
    n_tok = sum(len(done[i].tokens) for i in ids)
    print(f"served {len(ids)} requests, {n_tok} tokens in {dt:.3f}s ({n_tok / dt:.1f} tok/s, "
          f"arch={cfg.name}, moe_impl={cfg.moe_impl}, paged, prefill_mode={args.prefill_mode}, "
          f"device={eng.device})")
    decode = [m["decode_s"] for m in eng.metrics_log if m["tokens_this_tick"]]
    print(f"  {len(eng.metrics_log)} ticks; decode tick median "
          f"{(statistics.median(decode) * 1e3) if decode else float('nan'):.3f} ms over "
          f"{len(decode)} ticks; {eng.prefill_tokens_total} prefill tokens; "
          f"{eng.preemptions} preemptions; free pages {eng.pool.free_count}/{eng.n_pages}")
    if args.prefix_sharing:
        print(f"  prefix sharing: {eng.prefix_hits} hits, {eng.prefix_hit_tokens} hit tokens, "
              f"{eng.prefill_tokens_skipped} prefill tokens skipped, {eng.cow_copies} CoW copies")
    if eng.drafter is not None:
        sp = [m["spec"] for m in eng.metrics_log if "spec" in m]
        drafted = sum(s["drafted"] for s in sp)
        accepted = sum(s["accepted"] for s in sp)
        windows = sum(s["windows"] for s in sp)
        emitted = sum(s["emitted"] for s in sp)
        print(f"speculation: {emitted} tokens / {windows} verify passes = "
              f"{emitted / max(windows, 1):.2f} tok/verify (accept rate "
              f"{accepted / max(drafted, 1):.2f}, k={eng.spec_k}); {eng.spec_resyncs} drafter "
              "resyncs")
    report_obs(args, obs, cfg, dict(paged=True, requests=len(ids), tokens=n_tok, wall_s=dt,
                                    prefill_mode=args.prefill_mode))
    print("sample:", done[ids[0]].tokens[:10])


if __name__ == "__main__":
    main()
