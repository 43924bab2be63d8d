"""Static and runtime analysis of the port's serving and training steps
(``repro/analysis`` on eager PyTorch).

Four passes, one report format (``findings.Report``), one CLI
(``launch/analyze.py``):

  * :mod:`repro_torch.analysis.contracts` — step-signature contract checker
    (declared signature families run, close under reachable scheduler
    states, and predict the distinct signatures a workload calls each step
    with: one CUDA graph capture each).
  * :mod:`repro_torch.analysis.donation`  — in-place auditor (every tree
    JAX donates keeps its storage across the port's step).
  * :mod:`repro_torch.analysis.lint`      — AST host-sync lint over
    ``src/repro_torch`` with ``# analysis: allow(...)`` pragmas;
    :mod:`repro_torch.analysis.syncs` holds it against the syncs the card
    shows.
  * :mod:`repro_torch.analysis.graph`     — op-capture auditor (stray
    collectives, int8/int4 -> float dtype drift, capacity-padding dead
    compute).
"""
from repro_torch.analysis.findings import Finding, Report, SEVERITIES
from repro_torch.analysis.contracts import (
    ContractEntry,
    Workload,
    check_closure,
    check_contract,
    chunk_lengths,
    engine_contract,
    observe_steps,
    predict_compiles,
    reachable_chunk_lengths,
)
from repro_torch.analysis.donation import audit_inplace, leaves
from repro_torch.analysis.lint import LintConfig, lint_source, lint_tree, RULES
from repro_torch.analysis.graph import (
    audit_collectives,
    audit_dead_compute,
    audit_dtype_drift,
    audit_graph,
    capacity_dead_compute,
    capture,
)

__all__ = [
    "Finding", "Report", "SEVERITIES",
    "ContractEntry", "Workload", "check_contract", "check_closure",
    "chunk_lengths", "engine_contract", "observe_steps", "predict_compiles",
    "reachable_chunk_lengths",
    "audit_inplace", "leaves",
    "LintConfig", "lint_source", "lint_tree", "RULES",
    "audit_collectives", "audit_dead_compute", "audit_dtype_drift",
    "audit_graph", "capacity_dead_compute", "capture",
]
