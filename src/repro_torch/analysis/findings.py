"""Shared finding/report types of the analysis suite: a copy of
``repro/analysis/findings.py``, kept in sync by hand.

Every pass (contract checker, in-place auditor, host-sync lint, graph
auditor) emits :class:`Finding` records into one :class:`Report`; the
``launch/analyze.py`` CLI renders the report and turns it into an exit code.

Severity semantics:

  * ``error``   — a violated serving-discipline invariant (hot-path host
                  sync, reallocated in-place leaf, open-ended step-signature set,
                  stray collective).  ``analyze`` exits nonzero.
  * ``warning`` — the same patterns in cold paths (launch CLIs, trainers),
                  where a host sync is legitimate but worth an eyeball.
                  Fails only under ``--strict``.
  * ``info``    — accounting the other passes produce (predicted step
                  signatures, capacity-padding dead-compute fractions).  Never
                  fails the gate; it is the measurement channel.

Suppression: a finding whose source line (or the line above it) carries an
``# analysis: allow(<rule>) — <why>`` pragma is recorded as suppressed and
does not count toward the gate; ``render`` still lists suppressed counts so
pragma rot is visible.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclass
class Finding:
    rule: str  # e.g. "host-item", "donation-dropped", "contract-open"
    severity: str  # "error" | "warning" | "info"
    location: str  # "path/to/file.py:123" or "ContinuousEngine.decode"
    message: str
    suppressed: bool = False  # pragma'd findings stay in the report, inert

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r} (want {SEVERITIES})")

    def render(self) -> str:
        tag = "suppressed " if self.suppressed else ""
        return f"[{tag}{self.severity}] {self.rule} @ {self.location}: {self.message}"


@dataclass
class Report:
    """One pass's (or the whole suite's) findings, plus free-form metrics —
    the accounting channel (predicted step signatures, padded-compute
    fractions) that the CLI prints but never gates on."""

    findings: List[Finding] = field(default_factory=list)
    metrics: Dict[str, object] = field(default_factory=dict)

    def add(self, rule: str, severity: str, location: str, message: str,
            *, suppressed: bool = False) -> Finding:
        f = Finding(rule, severity, location, message, suppressed=suppressed)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.metrics.update(other.metrics)

    def active(self, severity: Optional[str] = None) -> List[Finding]:
        """Unsuppressed findings, optionally filtered by severity."""
        return [f for f in self.findings if not f.suppressed
                and (severity is None or f.severity == severity)]

    @property
    def errors(self) -> List[Finding]:
        return self.active("error")

    @property
    def warnings(self) -> List[Finding]:
        return self.active("warning")

    def failed(self, strict: bool = False) -> bool:
        return bool(self.errors) or (strict and bool(self.warnings))

    def render(self, *, show_info: bool = True, show_suppressed: bool = False) -> str:
        lines: List[str] = []
        order = {s: i for i, s in enumerate(SEVERITIES)}
        for f in sorted(self.findings, key=lambda f: (f.suppressed, order[f.severity], f.location)):
            if f.suppressed and not show_suppressed:
                continue
            if f.severity == "info" and not show_info:
                continue
            lines.append(f.render())
        for k in sorted(self.metrics):
            lines.append(f"[metric] {k} = {self.metrics[k]}")
        n_sup = sum(f.suppressed for f in self.findings)
        lines.append(
            f"-- {len(self.errors)} error(s), {len(self.warnings)} warning(s), "
            f"{len(self.active('info'))} info, {n_sup} suppressed --"
        )
        return "\n".join(lines)
