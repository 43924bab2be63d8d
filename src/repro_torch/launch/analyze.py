"""The analysis gate of the port (``repro/launch/analyze.py``): the passes of
``repro_torch.analysis`` over the serving engines, turned into an exit code.

  1. host-sync lint over the whole ``src/repro_torch`` tree;
  2. step-signature contract of the continuous (paged + prefix-sharing +
     chunked-prefill) and static engines of each ``--arch`` (reduced
     configs): every declared signature runs, the chunk family is closed
     under reachable scheduler states, and the predicted signature count is
     reported (one CUDA graph capture each under ROADMAP item 10);
  3. in-place audit: every step keeps the storage of the trees JAX donates
     (the caches of prefill and decode);
  4. graph audit of the decode and prefill steps (an op capture): no
     collective in a single-device step, no int8 / int4 -> float cast
     outside the kernels, and the capacity-padding dead compute of MoE
     archs (info).

Besides the ``--arch`` targets it also analyzes the fused-tick engine
(``nlg-350m-moe128``, ``moe_impl="grouped"``, ``prefill_mode="batched"``)
and, unless ``--no-ep``, the expert-parallel
serving engines of ``nlg-350m-moe128`` over 4 gloo ranks on the CPU (a (2,
2) mesh: the two-hop exchange), the capacity and the grouped schedules:
each rank's decode step is held to its schedule's collectives, counted per
MoE layer (``analysis/graph.py``'s ``SCHEDULE_COLLECTIVES``), with the
gathers of the slot layout where the decode's rows shard over the mesh.  The ranks start through
``serving/ep.py``'s ``launch``, under its group timeout and join deadline.

Exit 0 = no unsuppressed errors (``--strict``: no warnings either).  While
ROADMAP item 10's host syncs stay active (the engines' pageable uploads),
the lint keeps the exit code at 1; every other pass is clean.

  PYTHONPATH=src python -m repro_torch.launch.analyze --device cpu
  PYTHONPATH=src python -m repro_torch.launch.analyze --arch nlg-350m-moe128 --device cpu --no-ep
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from repro_torch.analysis import (
    Report,
    Workload,
    audit_graph,
    audit_inplace,
    check_closure,
    check_contract,
    engine_contract,
    lint_tree,
    predict_compiles,
)
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.models.model import init_params

DEFAULT_ARCHS = ("glm4-9b", "gemma3-27b")

# the scenario the contract's closure/prediction passes replay: mixed prompt
# lengths (page-aligned, odd, sub-page, exactly one chunk budget)
_WORKLOAD = Workload(prompt_lens=(16, 33, 7, 64), max_new=8, ticks=24)

EP_MESH = (2, 2)
EP_ARCH = "nlg-350m-moe128"


def _moe_ffn(cfg):
    for ls in cfg.layer_specs():
        if getattr(ls.ffn, "num_experts", 0):
            return ls.ffn
    return None


def _moe_spec(cfg, num_tokens: int) -> Optional[dict]:
    f = _moe_ffn(cfg)
    if f is None:
        return None
    impl = "grouped" if cfg.moe_impl in ("grouped", "ep_grouped") else cfg.moe_impl
    return {"num_tokens": num_tokens, "num_experts": f.num_experts, "top_k": f.top_k,
            "capacity_factor": f.capacity_factor, "impl": impl}


def build_engines(arch: str, *, device: str = "cpu", moe_impl: Optional[str] = None,
                  prefill_mode: str = "chunked", ep_mesh: Sequence[int] = ()):
    """(ContinuousEngine paged + prefix sharing, static Engine) for the
    reduced ``arch``."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = make_reduced(get_config(arch))
    if moe_impl is not None:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if ep_mesh:
        cfg = dataclasses.replace(cfg, ep_mesh=tuple(ep_mesh))
    params = init_params(cfg, seed=0, device=device)
    cont = ContinuousEngine(cfg, params, slots=4, capacity=128, paged=True, page_size=16,
                            prefix_sharing=True, prefill_mode=prefill_mode, device=device)
    stat = Engine(cfg, params, EngineConfig(max_batch=2, max_prefill=64, max_decode=8),
                  device=device)
    return cont, stat


def analyze_contracts(tag: str, engine, report: Report, *,
                      workload: Workload = _WORKLOAD) -> None:
    """Pass 2 on one engine: run + closure + signature-count prediction."""
    entries = engine_contract(engine)
    sub = Report()
    check_contract(entries, sub)
    if getattr(engine, "paged", False):
        check_closure(entries, capacity=engine.capacity, page_size=engine.page_size,
                      prefill_chunk=engine.prefill_chunk, workload=workload, report=sub)
        pred = predict_compiles(
            slots=engine.n_slots, capacity=engine.capacity, page_size=engine.page_size,
            prefill_chunk=engine.prefill_chunk, workload=workload,
            prefill_mode=engine.prefill_mode)
        sub.add("predicted-signatures", "info", tag,
                f"workload {tuple(workload.prompt_lens)} x{workload.max_new} new over "
                f"{workload.ticks} ticks calls: "
                + ", ".join(f"{k}={v}" for k, v in pred.items() if v)
                + f" distinct signatures (total {sum(pred.values())}: CUDA graph captures)")
        sub.metrics[f"contract.{tag}.predicted_signatures"] = sum(pred.values())
    for k in list(sub.metrics):
        if k.startswith("contract.") and not k.startswith(f"contract.{tag}"):
            sub.metrics[f"contract.{tag}.{k[len('contract.'):]}"] = sub.metrics.pop(k)
    report.extend(sub)


def analyze_inplace(tag: str, engine, report: Report) -> None:
    """Pass 3 on one engine: each contract entry's last sample keeps the
    storage of every tree it writes."""
    for e in engine_contract(engine):
        if not e.mutated or not e.sample:
            continue
        with torch.no_grad():
            audit_inplace(f"{tag}.{e.name}", e.fn, e.make(*e.sample[-1]), e.mutated, report,
                          returns=e.returns)


def analyze_graphs(tag: str, engine, report: Report) -> None:
    """Pass 4 on one engine: the decode step and the budget-length prefill
    chunk (or the batched tick's fixed-shape entry)."""
    by_name = {e.name: e for e in engine_contract(engine)}
    cfg = engine.cfg
    dec = by_name["decode"]
    n_dec = engine.n_slots if hasattr(engine, "n_slots") else dec.sample[-1][0]
    with torch.no_grad():
        audit_graph(f"{tag}.decode", dec.fn, dec.make(*dec.sample[-1]),
                    moe=_moe_spec(cfg, n_dec), report=report)
        for nm in ("prefill_chunk_first", "prefill_chunk_batched"):
            chunk = by_name.get(nm)
            if chunk is None:
                continue
            pt = chunk.sample[-1]
            nt = pt[0] if pt else engine.n_slots * engine.prefill_chunk
            audit_graph(f"{tag}.{nm}", chunk.fn, chunk.make(*pt), moe=_moe_spec(cfg, nt),
                        report=report)


def analyze_arch(arch: str, report: Report, *, device: str = "cpu",
                 moe_impl: Optional[str] = None, prefill_mode: str = "chunked",
                 tag: str = "") -> None:
    cont, stat = build_engines(arch, device=device, moe_impl=moe_impl, prefill_mode=prefill_mode)
    base = f"{arch}{tag}"
    for t, eng in ((f"{base}.continuous", cont), (f"{base}.static", stat)):
        analyze_contracts(t, eng, report)
        analyze_inplace(t, eng, report)
        analyze_graphs(t, eng, report)


def _ep_rank(rank: int, impl: str) -> list:
    """One rank of the EP gate: its engines' decode steps, each audited for
    its schedule's collectives; returns the findings as (severity, rule,
    location, message, suppressed) rows, and the report's metrics."""
    from repro_torch.analysis.graph import schedule_collectives
    from repro_torch.core.moe_serve import schedule_of
    from repro_torch.serving.ep import mesh_scope, slot_shard

    torch.manual_seed(0)
    cont, stat = build_engines(EP_ARCH, moe_impl=impl, ep_mesh=EP_MESH,
                               prefill_mode="batched" if impl == "grouped" else "chunked")
    report = Report()
    cfg = stat.cfg
    ffn = _moe_ffn(cfg)
    kernel = "grouped" if cfg.moe_impl == "ep_grouped" else "capacity"
    for tag, eng in (("static", stat), ("continuous", cont)):
        e = next(x for x in engine_contract(eng) if x.name == "decode")
        args = e.make(*e.sample[-1])
        T = eng.n_slots if hasattr(eng, "n_slots") else e.sample[-1][0]
        schedule = schedule_of(kernel, T, ffn)
        rows = slot_shard(eng._mesh, eng._mesh_rules, T,
                          eng.n_pages if getattr(eng, "paged", False) else None)
        allowed = schedule_collectives(cfg, schedule, EP_MESH, rows.axes if rows else (),
                                       paged=getattr(eng, "paged", False))
        with torch.no_grad(), mesh_scope(eng._mesh, eng._mesh_rules):
            audit_graph(f"{EP_ARCH}+ep-{impl}.{tag}.decode[{schedule}]", e.fn, args,
                        allowed_collectives=allowed, report=report)
    return ([(f.severity, f.rule, f"rank{rank}:{f.location}", f.message, f.suppressed)
             for f in report.findings],
            {k: v for k, v in report.metrics.items() if k.endswith((".collectives", ".kernels"))})


def analyze_ep(report: Report, *, timeout_s: float = 300.0) -> None:
    """The EP serving targets over 4 gloo ranks on the CPU (the module
    docstring)."""
    from repro_torch.serving.ep import launch

    world = EP_MESH[0] * EP_MESH[1]
    for impl in ("ep", "grouped"):
        for rank, (rows, metrics) in enumerate(launch(_ep_rank, world, backend="gloo",
                                                      args=(impl,), timeout_s=timeout_s)):
            for sev, rule, loc, msg, sup in rows:
                report.add(rule, sev, loc, msg, suppressed=sup)
            if rank == 0:
                report.metrics.update(metrics)


def _pkg_root() -> str:
    return str(Path(__file__).resolve().parents[1])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=list(DEFAULT_ARCHS),
                    help=f"registry archs to analyze, reduced (default: {DEFAULT_ARCHS})")
    ap.add_argument("--device", default="cuda", help="where the engines' steps run (cuda | cpu)")
    ap.add_argument("--strict", action="store_true", help="warnings fail the gate too")
    ap.add_argument("--no-ep", action="store_true",
                    help="skip the expert-parallel serving engines (4 gloo ranks on the CPU)")
    args = ap.parse_args(argv)

    report = lint_tree(_pkg_root())
    for arch in args.arch:
        analyze_arch(arch, report, device=args.device)
    analyze_arch("nlg-350m-moe128", report, device=args.device, moe_impl="grouped",
                 prefill_mode="batched", tag="+fused")
    if not args.no_ep:
        analyze_ep(report)
    print(report.render())
    failed = report.failed(strict=args.strict)
    print("analyze:", "FAIL" if failed else "OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
