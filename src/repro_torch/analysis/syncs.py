"""Where a step's host syncs come from, on the card: each one located at a
``file:line`` of ``src/repro_torch`` and held against the lint's findings.

``locate_syncs()`` runs its block under ``torch.profiler`` (CPU and CUDA
activities, ``with_stack=True``) and, around the profiler, under
``torch.cuda.set_sync_debug_mode("warn")``:

  * the profiler counts the sync points: the CUDA runtime's
    ``cudaStreamSynchronize`` / ``cudaDeviceSynchronize`` /
    ``cudaEventSynchronize`` calls and the synchronous ``cudaMemcpy``.  A
    device ``aten::_local_scalar_dense`` (``.item()``, ``int(t)``) and a
    device-to-host ``cudaMemcpyAsync`` into pageable memory each come with
    a ``cudaStreamSynchronize``, so they are counted through it; an
    ``aten::_local_scalar_dense`` without one reads a CPU tensor and is no
    sync (``not_syncs``);
  * sync-debug mode makes PyTorch warn at every synchronizing CUDA call
    (``.item()``, ``.cpu()``, a pageable host-to-device copy, ...), and
    ``torch.cuda.synchronize`` is wrapped for the block: each hook takes
    the innermost frame of the calling thread's stack that lies in
    ``src/repro_torch``, its exact line (the profiler's Python events carry
    a function's first line, not the calling line), or ``<caller>`` where
    none does (the harness's own read-backs, the profiler's start and stop).

The two must agree: every sync point the profiler counts is one located
site (``SyncLog.unlocated`` is the difference).  ``check_against_lint``
then requires every ``src/repro_torch`` site to be a lint finding, active
or suppressed.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch.analysis.findings import Report

SYNC_RUNTIME = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                "cudaMemcpy")
CALLER = "<caller>"
PKG_ROOT = Path(__file__).resolve().parents[1]


@dataclass
class SyncLog:
    sites: Dict[str, int] = field(default_factory=collections.Counter)  # file:line -> count
    profiler_syncs: int = 0  # the profiler's sync points in the block
    not_syncs: int = 0  # aten::_local_scalar_dense of CPU tensors (no sync)
    by_event: Dict[str, int] = field(default_factory=collections.Counter)

    @property
    def located(self) -> int:
        return sum(self.sites.values())

    @property
    def unlocated(self) -> int:
        return self.profiler_syncs - self.located

    def package_sites(self) -> Dict[str, int]:
        return {k: v for k, v in self.sites.items() if k != CALLER}

    def per_step(self, steps: int) -> str:
        """``file:line xN`` per step, most frequent first."""
        return "; ".join(f"{k} x{v / steps:g}" for k, v in
                         sorted(self.sites.items(), key=lambda kv: (-kv[1], kv[0])))


def _site(frame) -> str:
    """The innermost frame in the package (this module's own excepted)."""
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        try:
            rel = path.resolve().relative_to(PKG_ROOT).as_posix()
        except (ValueError, OSError):
            rel = None
        if rel is not None and rel != "analysis/syncs.py":
            return f"{rel}:{frame.f_lineno}"
        frame = frame.f_back
    return CALLER


@contextlib.contextmanager
def locate_syncs(log: SyncLog):
    """Run the block under the profiler and the sync hooks; fills ``log``."""
    from torch.profiler import ProfilerActivity, profile

    sync_fn = torch.cuda.synchronize

    def synchronize(*a, **k):
        log.sites[_site(sys._getframe(1))] += 1
        return sync_fn(*a, **k)

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            log.sites[_site(sys._getframe(1))] += 1

    mode = torch.cuda.get_sync_debug_mode()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=True)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.synchronize = synchronize
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with prof:
                yield log
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.synchronize = sync_fn
    for ev in prof.events():
        if ev.name in SYNC_RUNTIME:
            log.profiler_syncs += 1
            log.by_event[ev.name] += 1
        elif ev.name == "aten::_local_scalar_dense":
            if not any(c.name.startswith("cuda") for c in ev.cpu_children):
                log.not_syncs += 1


def check_against_lint(log: SyncLog, lint: Report, what: str) -> List[str]:
    """Every ``src/repro_torch`` site of ``log`` must be a lint finding
    (active or suppressed); raises otherwise, and when the profiler counted
    sync points no hook located.  Returns the sites with their findings."""
    by_loc = collections.defaultdict(list)
    for f in lint.findings:
        by_loc[f.location].append(f)
    missing = [s for s in log.package_sites() if s not in by_loc]
    if missing:
        raise AssertionError(f"{what}: host syncs at {missing} are no lint finding")
    if log.unlocated:
        raise AssertionError(f"{what}: the profiler counted {log.profiler_syncs} sync points "
                             f"({dict(log.by_event)}), the hooks located {log.located} "
                             f"({dict(log.sites)})")
    tag = lambda f: f.rule + (" suppressed" if f.suppressed else "")
    return [f"{s} ({'/'.join(sorted({tag(f) for f in by_loc[s]}))})"
            for s in sorted(log.package_sites())]
