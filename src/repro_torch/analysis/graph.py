"""Graph auditor over an op capture of an eager step
(``repro/analysis/graph.py``, which walks a jaxpr).

``capture(fn, *args)`` runs ``fn`` under a ``TorchDispatchMode`` that
records every aten op with its input and output dtypes and shapes.  The
port's kernels are ctypes calls the mode cannot see, so the kernel wrappers
and the workers of ``parallel/collectives.py`` report themselves through
``kernels/account.py``: each call is one entry (its launch key or
collective kind, and its arguments), and the plain version's own aten ops
inside it are not recorded, so a step captured on the CPU and on the card
is the same list.  A ``c10d`` op seen outside such a call (a raw
``torch.distributed`` call) is recorded as one too.

The audits, under JAX's rule names:

  * ``stray-collective``   — a collective a step does not allow (none in
                             a single-device step); an EP step is held to
                             its schedule's collectives, each kind at its
                             exact count (``collective-count``,
                             ``missing-collective``).
  * ``dtype-drift``        — an int8 / uint8 (int4 packs two values in one
                             byte) -> floating cast of a large tensor outside
                             a kernel: the dequantized copy the kernels exist
                             to avoid.  int32 position math is exempt.
  * ``capacity-padding``   — the dead compute of capacity-factor dispatch:
                             the expert MLP runs over the whole ``[E, C, D]``
                             buffer.  The analytic fraction (info) is checked
                             against the buffer the step actually ran (the
                             expert kernels' entries, or any batched matmul
                             with leading dim E), and, where the entries
                             carry the per-expert ``fill``, the step's
                             measured padded share is reported beside it.
"""
from __future__ import annotations

import collections
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Report
from repro_torch.kernels import account

# the collectives one MoE layer of each EP serving schedule makes in a step
# (core/moe_serve.py), by JAX prim name
SCHEDULE_COLLECTIVES = {
    "replicated_dense": {"all_gather": 1, "psum": 1},
    "replicated_grouped": {"psum": 2},
    "a2a": {"all_to_all": 2, "psum": 2, "all_gather": 1},
}

# dequantize sources: 8-bit storage (int4 values live two to a byte)
_QUANT_SRC = {torch.int8, torch.uint8}
_CASTS = {"aten._to_copy.default", "aten.copy_.default"}
# integer tensors an entry keeps a copy of (fill, positions, tables, counts)
_SNAPSHOT_MAX = 1 << 20


@dataclass
class TensorMeta:
    shape: tuple
    dtype: torch.dtype
    value: Optional[torch.Tensor] = None  # a host copy of a small integer tensor

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclass
class QuantMeta:
    """A ``QuantizedArray`` argument: its stored values and scales."""
    q: TensorMeta
    scale: TensorMeta
    bits: int
    shape: tuple


@dataclass
class OpRecord:
    kind: str  # "aten" | "kernel" | "collective" | "c10d"
    name: str  # aten op / kernel launch key / collective kind / c10d op
    inputs: List[TensorMeta] = field(default_factory=list)
    outputs: List[TensorMeta] = field(default_factory=list)
    args: Dict[str, Any] = field(default_factory=dict)  # kernel / collective arguments


@dataclass
class Capture:
    records: List[OpRecord] = field(default_factory=list)
    output: Any = None

    def of(self, kind: str) -> List[OpRecord]:
        return [r for r in self.records if r.kind == kind]

    def kernels(self) -> Dict[str, int]:
        return dict(collections.Counter(r.name for r in self.of("kernel")))

    def collectives(self) -> Dict[str, int]:
        return dict(collections.Counter(r.name for r in self.records
                                        if r.kind in ("collective", "c10d")))


def _meta(t: torch.Tensor, snapshot: bool = False) -> TensorMeta:
    value = None
    if snapshot and not t.is_floating_point() and t.device.type != "meta" \
            and t.numel() <= _SNAPSHOT_MAX:
        value = t.detach().to("cpu", copy=True)
    return TensorMeta(tuple(t.shape), t.dtype, value)


def _tensors(x) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if hasattr(x, "q") and hasattr(x, "scale") and hasattr(x, "bits"):
        return [x.q, x.scale]
    return []


def _arg_meta(v):
    if torch.is_tensor(v):
        return _meta(v, snapshot=True)
    if hasattr(v, "q") and hasattr(v, "scale") and hasattr(v, "bits"):
        return QuantMeta(_meta(v.q), _meta(v.scale), v.bits, tuple(v.shape))
    if isinstance(v, (tuple, list)) and v and all(torch.is_tensor(t) or t is None for t in v):
        return type(v)(_arg_meta(t) for t in v)
    if isinstance(v, (int, float, bool, str)) or v is None or hasattr(v, "axes_size"):
        return v  # scalars, and a collective's mesh
    return type(v).__name__


class _Capture(TorchDispatchMode):
    """The recorder ``kernels/account.py`` hands the wrappers while a
    capture runs."""

    def __init__(self, cap: Capture):
        super().__init__()
        self.cap = cap
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.depth == 0:
            name = str(func)
            kind = "c10d" if name.startswith("c10d.") else "aten"
            self.cap.records.append(OpRecord(
                kind, name, [_meta(t) for t in _tensors(args) + _tensors(kwargs or {})],
                [_meta(t) for t in _tensors(out)]))
        return out

    def _entry(self, kind: str, name: str, fn, kwargs: dict):
        account.recorder = None
        self.depth += 1  # the entry's own copies and the call's ops are not the step's
        try:
            rec = OpRecord(kind, name, args={k: _arg_meta(v) for k, v in kwargs.items()})
            rec.inputs = [_meta(t) for t in _tensors(list(kwargs.values()))]
            self.cap.records.append(rec)
            out = fn(**kwargs)
            rec.outputs = [_meta(t, snapshot=True) for t in _tensors(out)]
        finally:
            self.depth -= 1
            account.recorder = self
        return out

    def kernel(self, name: str, fn, **kwargs):
        return self._entry("kernel", name, fn, kwargs)

    def collective(self, name: str, fn, **kwargs):
        return self._entry("collective", name, fn, kwargs)


def capture(fn, *args, **kwargs) -> Capture:
    """Run ``fn(*args, **kwargs)`` once, recording its ops (the module
    docstring); ``Capture.output`` holds what it returned."""
    cap = Capture()
    mode = _Capture(cap)
    if account.recorder is not None:
        raise RuntimeError("capture: another capture is running")
    account.recorder = mode
    try:
        with mode:
            cap.output = fn(*args, **kwargs)
    finally:
        account.recorder = None
    return cap


def schedule_collectives(cfg, schedule: str, mesh_shape) -> Dict[str, int]:
    """The collectives a step of ``schedule`` makes over a mesh of
    ``mesh_shape``: the per-layer counts times the MoE layers (on two axes
    the exchange takes two hops, two all-to-alls each way)."""
    n_moe = sum(1 for ls in cfg.layer_specs() if ls.ffn.kind == "moe")
    per = dict(SCHEDULE_COLLECTIVES[schedule])
    if len(mesh_shape) == 2 and "all_to_all" in per:
        per["all_to_all"] *= 2
    return {k: v * n_moe for k, v in per.items()}


def audit_collectives(cap: Capture, name: str, report: Optional[Report] = None, *,
                      allowed: Union[Sequence[str], Mapping[str, int]] = ()) -> Report:
    """Flag collectives in a step declared single-device; ``allowed`` kinds
    pass (a mapping: each at exactly its count)."""
    report = report if report is not None else Report()
    seen = cap.collectives()
    for p, n in sorted(seen.items()):
        if p not in allowed:
            report.add(
                "stray-collective", "error", name,
                f"{n}x `{p}` in a step that does not allow it: a mesh leaking into a "
                "single-device step, or a schedule exchanging more than it declares")
        elif isinstance(allowed, Mapping) and allowed[p] != n:
            report.add("collective-count", "error", name,
                       f"{n}x `{p}`, the schedule allows exactly {allowed[p]}")
    if isinstance(allowed, Mapping):
        for p, n in sorted(allowed.items()):
            if n and p not in seen:
                report.add("missing-collective", "error", name,
                           f"no `{p}` where the schedule makes {n}: the exchange fell away")
    report.metrics[f"graph.{name}.collectives"] = sum(seen.values())
    return report


def audit_dtype_drift(cap: Capture, name: str, report: Optional[Report] = None, *,
                      min_elements: int = 4096) -> Report:
    """Flag int8 / uint8 -> floating casts of ``min_elements`` or more
    outside the kernels (a materialized dequantize)."""
    report = report if report is not None else Report()
    hits = 0
    for r in cap.of("aten"):
        if r.name not in _CASTS or not r.inputs or not r.outputs:
            continue
        src = r.inputs[-1] if r.name == "aten.copy_.default" else r.inputs[0]
        dst = r.outputs[0]
        if src.dtype in _QUANT_SRC and dst.dtype.is_floating_point \
                and src.numel >= min_elements:
            hits += 1
            if hits <= 4:  # one finding per site, capped; total in metrics
                report.add(
                    "dtype-drift", "error", name,
                    f"cast {src.dtype}{list(src.shape)} -> {dst.dtype} outside a kernel: the "
                    "dequantized copy is 2-8x the quantized buffer; read it in the kernel")
    report.metrics[f"graph.{name}.quant_float_casts"] = hits
    return report


def capacity_dead_compute(num_tokens: int, num_experts: int, top_k: int,
                          capacity_factor: float) -> Dict[str, float]:
    """Analytic padded-compute fraction of capacity-factor dispatch: the
    dense ``[E, C, d]`` expert buffer runs every slot through the MLP whether
    or not gating filled it."""
    cap = max(1, int(capacity_factor * num_tokens * top_k / num_experts))
    slots = num_experts * cap
    routed = min(num_tokens * top_k, slots)
    return {
        "capacity": cap,
        "slots": slots,
        "routed_upper_bound": routed,
        "padded_fraction": 1.0 - routed / slots,
    }


_EXPERT_KERNELS = ("expert_mlp", "expert_mlp_quant")
_MATMULS = ("aten.bmm.default", "aten.baddbmm.default")


def audit_dead_compute(cap: Capture, name: str, *, num_tokens: int, num_experts: int,
                       top_k: int, capacity_factor: float, impl: str = "einsum",
                       report: Optional[Report] = None) -> Report:
    """Cross-check the analytic padding fraction (at the port's capacity,
    ``core/gating.expert_capacity``: ``capacity_dead_compute``'s padded to a
    multiple of 8) against the capacity buffers the step ran (the expert
    kernels' ``xe`` and any batched matmul with leading dim
    ``num_experts``), and report the dead-compute share as info; where the
    expert kernels' entries carry ``fill``, the measured padded share of the
    run (``padded_fraction_measured``: 1 - sum(fill) / (E * C) over the
    calls) too.

    ``impl="grouped"`` (dropless): no ``[E, C, d]`` buffer exists, so the
    cross-check would be a false finding there; the info line reports the
    worst-case tile padding instead.  ``impl in ("ep", "ep_serve")`` under a
    mesh: the expert buffers are per-shard ``[E_local, C', d]``, so only the
    analytic share is reported."""
    report = report if report is not None else Report()
    if num_experts <= 0:
        return report
    if impl == "grouped":
        from repro_torch.core.dispatch_grouped import GROUPED_TILE, grouped_rows

        tk = num_tokens * top_k
        ct = grouped_rows(num_tokens, top_k, num_experts, GROUPED_TILE)
        frac = 1.0 - tk / ct
        report.add(
            "capacity-padding", "info", name,
            f"grouped (dropless) dispatch: no [E, C] capacity buffer in the step; "
            f"worst-case tile padding is {ct - tk} of {ct} sorted rows ({frac:.1%}, "
            f"tile={GROUPED_TILE}), and every routed token is kept regardless of skew")
        report.metrics[f"graph.{name}.expert_dots"] = 0
        report.metrics[f"graph.{name}.padded_fraction"] = round(frac, 4)
        return report
    from repro_torch.core.gating import expert_capacity

    stats = capacity_dead_compute(num_tokens, num_experts, top_k, capacity_factor)
    # the port's gating pads the capacity to a multiple of 8 (at least 8)
    # (core/gating.py): the buffer the step runs
    C = expert_capacity(num_tokens, num_experts, top_k, capacity_factor)
    frac = 1.0 - min(num_tokens * top_k, num_experts * C) / (num_experts * C)
    if impl in ("ep", "ep_serve") and cap is None:
        report.add(
            "capacity-padding", "info", name,
            f"expert-parallel capacity dispatch: per-shard [E_local, C={C}] buffers, >= "
            f"{frac:.1%} capacity padding (analytic)")
        report.metrics[f"graph.{name}.expert_dots"] = 0
        report.metrics[f"graph.{name}.padded_fraction"] = round(frac, 4)
        return report
    expert_dots = 0
    graph_caps: set = set()
    filled = slots_run = 0
    for r in cap.records:
        if r.kind == "kernel" and r.name in _EXPERT_KERNELS:
            xe = r.args.get("xe")
            if not isinstance(xe, TensorMeta) or xe.shape[0] != num_experts:
                continue
            expert_dots += 1
            graph_caps.add(int(xe.shape[1]))
            fill = r.args.get("fill")
            if isinstance(fill, TensorMeta) and fill.value is not None:
                filled += int(fill.value.clamp(0, xe.shape[1]).sum())
                slots_run += xe.shape[0] * xe.shape[1]
        elif r.kind == "aten" and r.name in _MATMULS and r.inputs:
            lhs = r.inputs[-2] if r.name == "aten.baddbmm.default" else r.inputs[0]
            if len(lhs.shape) == 3 and lhs.shape[0] == num_experts:
                expert_dots += 1
                graph_caps.add(int(lhs.shape[1]))
    if expert_dots and graph_caps != {C}:
        report.add(
            "capacity-mismatch", "error", name,
            f"expert dispatch buffers in the step use capacity {sorted(graph_caps)} but the "
            f"config's gating arithmetic gives {C}: the contract and the step disagree")
    if expert_dots:
        report.add(
            "capacity-padding", "info", name,
            f"{expert_dots} expert call(s) over [E={num_experts}, C={C}] buffers: >= "
            f"{frac:.1%} of their compute is capacity padding (slots gating left empty still "
            f"run the MLP; {stats['padded_fraction']:.1%} at the unpadded capacity "
            f"{stats['capacity']}): the dropless baseline number")
    report.metrics[f"graph.{name}.expert_dots"] = expert_dots
    report.metrics[f"graph.{name}.padded_fraction"] = round(frac, 4)
    if slots_run:
        report.metrics[f"graph.{name}.padded_fraction_measured"] = 1.0 - filled / slots_run
    return report


def audit_graph(name: str, fn, args: Sequence, *,
                allowed_collectives: Union[Sequence[str], Mapping[str, int]] = (),
                moe: Optional[Dict[str, Any]] = None,
                report: Optional[Report] = None,
                captured: Optional[Capture] = None) -> Report:
    """Run every graph check on ``fn(*args)``, captured once (or on
    ``captured``).  ``allowed_collectives``: none for a single-device step;
    for an EP step its schedule's kinds, each held to its exact count
    (``schedule_collectives``), so an exchange that fell away is a finding
    too.  ``moe`` carries the gating arithmetic for the dead-compute pass:
    ``{num_tokens, num_experts, top_k, capacity_factor, impl}``."""
    report = report if report is not None else Report()
    if captured is None:
        try:
            captured = capture(fn, *args)
        except Exception as exc:  # a step that cannot run is the finding
            report.add("graph-trace-failed", "error", name,
                       f"could not run for the graph audit: {exc!r}".replace("\n", " ")[:300])
            return report
    report.metrics[f"graph.{name}.kernels"] = captured.kernels()
    audit_collectives(captured, name, report, allowed=allowed_collectives)
    audit_dtype_drift(captured, name, report)
    if moe:
        audit_dead_compute(captured, name, report=report, **moe)
    return report
