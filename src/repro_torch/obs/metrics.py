"""Counters, gauges, and fixed-bucket histograms for serving/training
telemetry, a copy of ``repro/obs/metrics.py`` (the port imports nothing of
the JAX package): the same names, buckets and snapshot schema, so one
snapshot reads the same from either package.  Production MoE serving stands
or falls on what can be measured: latency percentiles, expert load, cost per
token.

Design constraints, in order:

  * **dependency-free and allocation-light** — a ``Histogram.observe`` is a
    ``bisect`` into precomputed bucket bounds plus three float updates, so
    per-token SLO accounting (TTFT, TPOT, queue-wait) costs microseconds and
    never stores samples;
  * **percentiles without sample storage** — buckets are log-spaced, so
    p50/p95/p99 come from cumulative-count bucket interpolation.  The error
    is bounded by the bucket's log width (``(hi/lo)^(1/n)`` per bucket,
    ~±4% at the defaults), which tests/test_obs.py pins down and
    tests/test_torch_obs.py holds equal across the two copies;
  * **one source of truth** — everything the CLI prints and everything
    ``--metrics-out`` writes comes from the same ``snapshot()`` dict, so the
    two can never disagree.
"""
from __future__ import annotations

import json
import math
import time
from bisect import bisect_right
from typing import Dict, List, Optional


class Counter:
    """Monotonic counter.  ``inc`` accepts any non-negative increment."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "unit", "value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = None

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed log-spaced-bucket histogram: percentiles via bucket
    interpolation, no sample storage.

    Buckets: ``n_buckets`` geometric intervals spanning ``[lo, hi)`` plus an
    underflow bucket (``< lo``, includes zero/negative) and an overflow
    bucket (``>= hi``).  A percentile inside ``[lo, hi)`` is log-linearly
    interpolated within its bucket, so the worst-case relative error is one
    bucket's geometric width; underflow resolves to ``min_seen..lo`` and
    overflow to ``hi..max_seen`` (linear), keeping estimates finite and
    inside the observed range.
    """

    __slots__ = ("name", "unit", "lo", "hi", "bounds", "counts", "count",
                 "total", "min_seen", "max_seen")

    def __init__(self, name: str, unit: str = "s", lo: float = 1e-6,
                 hi: float = 100.0, n_buckets: int = 64):
        assert lo > 0 and hi > lo and n_buckets >= 1
        self.name = name
        self.unit = unit
        self.lo = lo
        self.hi = hi
        ratio = (hi / lo) ** (1.0 / n_buckets)
        # bounds[i] = upper edge of bucket i (i in 0..n_buckets-1 regular);
        # index layout: [underflow] + n_buckets regular + [overflow]
        self.bounds: List[float] = [lo * ratio ** (i + 1) for i in range(n_buckets)]
        self.counts: List[int] = [0] * (n_buckets + 2)
        self.count = 0
        self.total = 0.0
        self.min_seen = math.inf
        self.max_seen = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min_seen:
            self.min_seen = v
        if v > self.max_seen:
            self.max_seen = v
        if v < self.lo:
            self.counts[0] += 1
        elif v >= self.hi:
            self.counts[-1] += 1
        else:
            self.counts[1 + bisect_right(self.bounds, v)] += 1

    def reset(self) -> None:
        self.counts = [0] * len(self.counts)
        self.count = 0
        self.total = 0.0
        self.min_seen = math.inf
        self.max_seen = -math.inf

    # -- percentile estimation ------------------------------------------
    def _bucket_edges(self, idx: int):
        """(lower, upper) value edges of bucket ``idx`` in counts[] space."""
        if idx == 0:  # underflow: min_seen .. lo
            return min(self.min_seen, self.lo), self.lo
        if idx == len(self.counts) - 1:  # overflow: hi .. max_seen
            return self.hi, max(self.max_seen, self.hi)
        lower = self.lo if idx == 1 else self.bounds[idx - 2]
        return lower, self.bounds[idx - 1]

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-quantile (``q`` in [0, 1]) by cumulative-count
        bucket interpolation.  Returns nan when empty."""
        if self.count == 0:
            return math.nan
        if self.count == 1:
            return self.min_seen
        target = q * self.count
        acc = 0
        for idx, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= target:
                frac = (target - acc) / c
                frac = min(max(frac, 0.0), 1.0)
                lower, upper = self._bucket_edges(idx)
                if idx in (0, len(self.counts) - 1) or lower <= 0:
                    est = lower + (upper - lower) * frac  # linear at the tails
                else:
                    est = lower * (upper / lower) ** frac  # log-linear inside
                # clamp into the observed range — interpolation must never
                # manufacture values outside [min_seen, max_seen]
                return min(max(est, self.min_seen), self.max_seen)
            acc += c
        return self.max_seen

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "unit": self.unit}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.min_seen,
            "max": self.max_seen,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "unit": self.unit,
        }


class MetricsRegistry:
    """Get-or-create registry of named metrics with one ``snapshot()``.

    ``enabled=False`` turns every get-or-create into a shared no-op metric
    (observes/incs go nowhere) — the benchmark baseline for the <1%-overhead
    guard on the serving tick."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, unit: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = Counter(name, unit)
            if self.enabled:
                self._counters[name] = c
        return c

    def gauge(self, name: str, unit: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = Gauge(name, unit)
            if self.enabled:
                self._gauges[name] = g
        return g

    def histogram(self, name: str, unit: str = "s", lo: float = 1e-6,
                  hi: float = 100.0, n_buckets: int = 64) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = Histogram(name, unit, lo, hi, n_buckets)
            if self.enabled:
                self._histograms[name] = h
        return h

    def reset_all(self) -> None:
        """Zero every registered metric IN PLACE (callers hold direct
        references to the metric objects, so replacing them would silently
        disconnect the telemetry source).  Used to drop warmup/compile
        samples before a measured run."""
        for group in (self._counters, self._gauges, self._histograms):
            for m in group.values():
                m.reset()

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """{"counters": {name: value}, "gauges": {...}, "histograms":
        {name: {count, sum, min, max, p50, p90, p95, p99, unit}}}."""
        return {
            "counters": {n: c.snapshot() for n, c in sorted(self._counters.items())},
            "gauges": {n: g.snapshot() for n, g in sorted(self._gauges.items())
                       if g.value is not None},
            "histograms": {n: h.snapshot() for n, h in sorted(self._histograms.items())},
        }

    def write_jsonl(self, path: str, extra: Optional[dict] = None) -> None:
        """Append one JSON line: {"ts": unix_s, **extra, **snapshot()}."""
        row = {"ts": time.time()}
        if extra:
            row.update(extra)
        row.update(self.snapshot())
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def render(self, prefix: str = "") -> str:
        """Human-readable render of the SAME snapshot the JSON export writes
        (counters one block, gauges one block, histograms one line each with
        count/mean/p50/p95/p99)."""
        snap = self.snapshot()
        lines: List[str] = []
        if snap["counters"]:
            pairs = [f"{n}={v:g}" if isinstance(v, float) else f"{n}={v}"
                     for n, v in snap["counters"].items()]
            lines.append(prefix + "counters: " + " ".join(pairs))
        if snap["gauges"]:
            lines.append(prefix + "gauges:   " + " ".join(
                f"{n}={v:.4g}" for n, v in snap["gauges"].items()))
        for n, h in snap["histograms"].items():
            if not h["count"]:
                continue
            u = h["unit"]
            lines.append(
                prefix + f"{n}: n={h['count']} mean={h['mean']:.4g}{u} "
                f"p50={h['p50']:.4g}{u} p95={h['p95']:.4g}{u} "
                f"p99={h['p99']:.4g}{u} max={h['max']:.4g}{u}"
            )
        return "\n".join(lines)
