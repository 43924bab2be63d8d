"""Serving launcher of the port: randomly initialises (or loads) a model and
serves synthetic requests through the static batched engine, reporting
prefill and per-step decode latency, or with ``--paged`` through the
continuous-batching engine over a paged KV pool (chunked prefill), reporting
its per-tick numbers.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b \\
      --reduced --moe-impl grouped              # on the card
  ... --device cpu                              # on the CPU (plain versions)
  ... --paged --page-size 16 --pages 64 --slots 4 --prefill-chunk 32 --device cpu

A subset of ``repro.launch.serve``'s flags; the others exit with an error
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.models.model import init_params
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request

# flags of the JAX launcher this slice does not port -> where they are queued
UNPORTED = {
    "--quant-bits": "queue 1 item 4 (quantization)",
    "--quant-policy": "queue 1 item 4 (quantization)",
    "--quant-group-size": "queue 1 item 4 (quantization)",
    "--kv-bits": "queue 1 item 4 (quantization)",
    "--prefix-sharing": "queue 1 item 3 (prefix sharing)",
    "--n-samples": "queue 1 item 3 (submit_n)",
    "--spec-draft": "queue 1 item 6 (speculative decoding)",
    "--spec-k": "queue 1 item 6 (speculative decoding)",
    "--ep-devices": "queue 1 item 7 (expert parallelism)",
    "--trace-out": "queue 1 item 9 (tooling)",
    "--metrics-out": "queue 1 item 9 (tooling)",
    "--obs-routing": "queue 1 item 9 (tooling)",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory in the JAX package's format")
    ap.add_argument("--moe-impl", default=None, choices=[None, "grouped"],
                    help="MoE dispatch; only 'grouped' (dropless, the grouped "
                         "CUDA kernel) is ported")
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
    ap.add_argument("--prefill-mode", default="chunked", choices=["chunked"],
                    help="with --paged: only 'chunked' is ported (ROADMAP.md, queue 1 item 3: "
                         "batched prefill)")
    for flag in UNPORTED:
        ap.add_argument(flag, nargs="?", const=True, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet (ROADMAP.md, {item})")
    if (args.prefill_chunk or args.slots or args.pages) and not args.paged:
        ap.error("--pages/--slots/--prefill-chunk apply to the paged engine; pass --paged")
    if args.paged and args.prefill_chunk and args.prefill_chunk < args.page_size:
        ap.error(f"--prefill-chunk {args.prefill_chunk} must be >= --page-size "
                 f"{args.page_size} (chunk boundaries are page-aligned)")
    if args.temperature <= 0.0 and (args.top_k or args.top_p):
        ap.error("--top-k/--top-p have no effect at --temperature 0 (greedy); "
                 "pass --temperature > 0")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    if args.top_k > cfg.vocab_size:
        ap.error(f"--top-k {args.top_k} exceeds vocab_size {cfg.vocab_size}")
    if args.moe_impl:
        cfg = cfg.replace(moe_impl=args.moe_impl)

    if args.ckpt:
        from repro_torch.convert import load_checkpoint

        params = load_checkpoint(args.ckpt, cfg, args.device)
    else:
        params = init_params(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist(),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    if args.paged:
        serve_paged(args, cfg, params, reqs)
        return
    ec = EngineConfig(max_batch=args.batch, max_prefill=args.prompt_len,
                      max_decode=args.new_tokens, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p)
    eng = Engine(cfg, params, ec, device=args.device)
    eng.generate(reqs[: args.batch])  # warm-up: builds the kernels on the card
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
    print("sample:", responses[0].tokens[:10])


def serve_paged(args, cfg, params, reqs) -> None:
    eng = ContinuousEngine(
        cfg, params, slots=args.slots or args.batch, capacity=args.prompt_len + args.new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, paged=True,
        page_size=args.page_size, n_pages=args.pages, prefill_chunk=args.prefill_chunk,
        prefill_mode=args.prefill_mode, device=args.device)
    print(f"paged pool: {eng.n_pages} pages x {eng.page_size} tokens, {eng.n_slots} slots, "
          f"capacity {eng.capacity}, prefill chunk {eng.prefill_chunk}")
    # warm-up: builds the kernels on the card; the request completes, so the
    # pool starts the timed run empty
    eng.submit(Request(prompt=reqs[0].prompt, max_new_tokens=2))
    eng.run_until_done()
    eng.done.clear()
    eng.metrics_log.clear()
    eng.preemptions = eng.prefill_tokens_total = 0
    t0 = time.perf_counter()
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
    print("sample:", done[ids[0]].tokens[:10])


if __name__ == "__main__":
    main()
