"""Render the dry run's JSON (``launch/dryrun.py --out``) as markdown tables
(``repro/launch/report.py``): per mesh, each (arch, shape) with its bytes a
rank, whether it fits one H100's 80 GB, and its roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.report dryrun.json
"""
from __future__ import annotations

import json
import sys


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1.0:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def table(results, mesh: str) -> str:
    rows = [
        "| arch | shape | params | grads + moments | caches | total a rank | fits 80 GB | "
        "compute | memory | collective | dominant |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skipped":
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | | | |")
            continue
        b = r["bytes"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_b(b['params'])} | "
            f"{fmt_b(b['grads'] + b['moments'])} | {fmt_b(b['caches'])} | "
            f"{fmt_b(r['total_bytes'])} | {'yes' if r['fits'] else 'no'} | "
            f"{fmt_s(r['t_compute_s'])} | {fmt_s(r['t_memory_s'])} | "
            f"{fmt_s(r['t_collective_s'])} | **{r['dominant']}** |")
    return "\n".join(rows)


def bottleneck_notes(results) -> str:
    out = []
    for r in results:
        if r.get("mesh") != "single" or r["status"] != "ok":
            continue
        dom = r["dominant"]
        if dom == "memory":
            note = "shrink traffic: lower-precision weights and caches (MoQ, int8 KV), fewer reads"
        elif dom == "collective":
            note = "re-schedule the exchange: the two-hop all-to-all, overlap with compute"
        else:
            note = "compute-bound: near the roofline, tensor-core utilization of the kernels"
        out.append(f"- **{r['arch']} × {r['shape']}**: dominant={dom} -> {note}")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun.json"
    with open(path) as f:
        results = json.load(f)
    for mesh in dict.fromkeys(r["mesh"] for r in results):
        ranks = next(r["ranks"] for r in results if r["mesh"] == mesh)
        title = "one H100" if ranks == 1 else f"EP over {ranks} ranks, one H100 each"
        print(f"### {title} ({mesh})\n")
        print(table(results, mesh))
        print()
    print(bottleneck_notes(results))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n{n_ok} ok / {n_skip} documented skips / {len(results)} pairs.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
