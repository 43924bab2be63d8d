"""Retrace watchdog (``repro/obs/retrace.py``): per-tick compile accounting
for the serving engines.

In the JAX package every engine step is a jitted function whose trace
cache ``_cache_size()`` reports; the watchdog samples the sizes of all
registered functions each tick, reports the delta as that tick's compile
count, declares the engine steady after ``steady_after`` ticks without a
compile of a primary function, and warns on (and counts) every later one.

The port compiles no step function: its engines run eagerly and register
nothing, so ``serve.retraces`` stays 0 and ``snapshot()`` says
``"active": False``, as it does for any registry whose functions expose no
cache size.  The CUDA graph captures of the steps (ROADMAP.md, queue 1 item
10) will register here: a capture per shape is this watchdog's compile, a
re-capture after warm-up its retrace.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional


def jit_cache_size(fn) -> Optional[int]:
    """Cache entry count of a compiled callable (its ``_cache_size``), or
    None when it exposes none (the watchdog is then inactive)."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        n = probe() if callable(probe) else probe
    except Exception:
        return None
    return int(n) if isinstance(n, int) else None


class RetraceWatchdog:
    """Tracks compile-count deltas across engine ticks.

    Usage: ``register`` each compiled function at engine construction, call
    ``tick()`` once per scheduler step; it returns the compilations since
    the previous call and keeps the steady-state accounting.  ``active`` is
    True while some registered function exposes a cache size."""

    def __init__(self, steady_after: int = 3,
                 warn_fn: Callable[[str], None] = None):
        self.steady_after = steady_after
        self.warn_fn = warn_fn if warn_fn is not None else (
            lambda msg: warnings.warn(msg, RuntimeWarning, stacklevel=3))
        self._fns: Dict[str, object] = {}
        self._aux: set = set()  # names exempt from steady-state warnings
        self._last: Dict[str, int] = {}
        self.total_compiles = 0  # lifetime compiles seen across all fns
        self.steady_retraces = 0  # compiles AFTER steady state was reached
        self._zero_streak = 0
        self.steady = False
        self.active = False  # no registered fn exposes a cache size (yet)

    def register(self, name: str, fn, aux: bool = False) -> None:
        """``aux=True`` marks a function whose compiles COUNT but never fire
        the steady-state warning (admission prefills compile once per novel
        length, page helpers on first use).  Only non-aux functions carry
        the never-recompile-after-warm-up contract."""
        if fn is None:
            return
        self._fns[name] = fn
        if aux:
            self._aux.add(name)
        size = jit_cache_size(fn)
        self._last[name] = 0 if size is None else size
        self.active = self.active or size is not None

    def _sizes(self) -> Dict[str, int]:
        out = {}
        for name, fn in self._fns.items():
            size = jit_cache_size(fn)
            if size is not None:
                out[name] = size
        return out

    def tick(self) -> int:
        """Compiles since the last tick (0 when inactive)."""
        sizes = self._sizes()
        if not sizes:
            self.active = False
            return 0
        fresh = 0
        primary_fresh = 0
        culprits = []
        for name, size in sizes.items():
            prev = self._last.get(name, 0)
            d = size - prev
            if d > 0:
                fresh += d
                # a primary fn's first-ever compile is warm-up however late
                # it lands; the contract is about RE-compiling, prev > 0
                if name not in self._aux and prev > 0:
                    primary_fresh += d
                    culprits.append(f"{name}(+{d})")
            self._last[name] = size
        self.total_compiles += fresh
        if primary_fresh == 0:
            self._zero_streak += 1
            if self._zero_streak >= self.steady_after:
                self.steady = True
        else:
            self._zero_streak = 0
            if self.steady:
                self.steady_retraces += primary_fresh
                self.warn_fn(
                    "steady-state engine tick recompiled: "
                    + ", ".join(culprits)
                    + " — a fixed-shape decode tick should never recompile "
                    "(shape or static-arg drift?)"
                )
        return fresh

    def registry(self) -> Dict[str, bool]:
        """name -> is-primary for every registered function."""
        return {name: name not in self._aux for name in self._fns}

    def snapshot(self) -> dict:
        return {
            "active": self.active,
            "total_compiles": self.total_compiles,
            "steady": self.steady,
            "steady_retraces": self.steady_retraces,
            "per_fn": dict(self._last),
        }
