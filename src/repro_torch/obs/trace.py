"""Request-lifecycle tracer: spans and instants exported as Chrome/Perfetto
``trace_event`` JSON (a copy of ``repro/obs/trace.py``).

The serving scheduler emits one *track* per decode slot (what physical
resource was doing when), one per request (queued → admitted → prefill
chunk(s) → decode → complete, plus preemption / CoW / prefix-hit instants),
and one for the engine itself (tick spans, retrace warnings).  Tracks map
onto Chrome's process/thread model: a track *group* ("slot", "request",
"engine") becomes a pid, the id within the group becomes a tid, and metadata
events name both so Perfetto renders labeled swimlanes.

Open ``chrome://tracing`` or https://ui.perfetto.dev and load the exported
file (``Tracer.export`` / ``serve.py --trace-out``).

Overhead contract: when ``enabled=False`` every method returns after a
single attribute test — engines additionally hoist the check by holding
``tracer if tracer.enabled else None`` — so tracing on the serving hot
path costs one attribute test per site when off.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

Track = Tuple[str, int]  # (group, id) -> (pid, tid)


class Tracer:
    """Span/event recorder.  All methods no-op when ``enabled=False``.

    Spans on one track must nest (Chrome's B/E model is a per-thread stack);
    ``end`` closes the innermost open span.  ``ts`` values are seconds from
    an arbitrary epoch shared with ``time.perf_counter`` so callers can pass
    timestamps they already took for SLO accounting."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._events: List[dict] = []
        self._open: Dict[Track, List[dict]] = {}  # per-track span stacks
        self._groups: Dict[str, int] = {}  # group name -> pid
        self._named: set = set()  # (pid, tid) already carrying metadata
        self._t0 = time.perf_counter()

    # -- internals ------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter()

    def _us(self, ts: Optional[float]) -> float:
        return ((self._now() if ts is None else ts) - self._t0) * 1e6

    def _ids(self, track: Track) -> Tuple[int, int]:
        group, tid = track
        pid = self._groups.get(group)
        if pid is None:
            pid = len(self._groups) + 1
            self._groups[group] = pid
            self._events.append({"ph": "M", "pid": pid, "tid": 0,
                                 "name": "process_name",
                                 "args": {"name": group}})
        if (pid, tid) not in self._named:
            self._named.add((pid, tid))
            self._events.append({"ph": "M", "pid": pid, "tid": tid,
                                 "name": "thread_name",
                                 "args": {"name": f"{group} {tid}"}})
        return pid, tid

    # -- spans ----------------------------------------------------------
    def begin(self, track: Track, name: str, ts: Optional[float] = None,
              args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        pid, tid = self._ids(track)
        ev = {"ph": "B", "pid": pid, "tid": tid, "ts": self._us(ts),
              "name": name, "cat": track[0]}
        if args:
            ev["args"] = args
        self._events.append(ev)
        self._open.setdefault(track, []).append(ev)

    def end(self, track: Track, ts: Optional[float] = None,
            args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        stack = self._open.get(track)
        if not stack:
            return  # tolerate stray ends — export stays well-formed
        b = stack.pop()
        pid, tid = self._ids(track)
        ev = {"ph": "E", "pid": pid, "tid": tid,
              "ts": max(self._us(ts), b["ts"]), "name": b["name"],
              "cat": track[0]}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def span(self, track: Track, name: str, args: Optional[dict] = None):
        """``with tracer.span(("engine", 0), "tick"): ...``"""
        return _Span(self, track, name, args)

    def instant(self, track: Track, name: str, ts: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        pid, tid = self._ids(track)
        ev = {"ph": "i", "pid": pid, "tid": tid, "ts": self._us(ts),
              "name": name, "s": "t", "cat": track[0]}
        if args:
            ev["args"] = args
        self._events.append(ev)

    # -- export ---------------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self._events)

    def trace_events(self, close_open: bool = True) -> List[dict]:
        """The event list, with any still-open spans closed at "now" so the
        JSON is always loadable mid-run."""
        out = list(self._events)
        if close_open:
            now = self._us(None)
            for track, stack in self._open.items():
                pid, tid = self._groups[track[0]], track[1]
                for b in reversed(stack):
                    out.append({"ph": "E", "pid": pid, "tid": tid,
                                "ts": now, "name": b["name"], "cat": track[0]})
        return out

    def export(self, path: str) -> int:
        """Write Chrome trace JSON; returns the number of events written."""
        evs = self.trace_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
        return len(evs)


class _Span:
    __slots__ = ("_tr", "_track", "_name", "_args")

    def __init__(self, tr: Tracer, track: Track, name: str, args):
        self._tr = tr
        self._track = track
        self._name = name
        self._args = args

    def __enter__(self):
        self._tr.begin(self._track, self._name, args=self._args)
        return self

    def __exit__(self, *exc):
        self._tr.end(self._track)
        return False
