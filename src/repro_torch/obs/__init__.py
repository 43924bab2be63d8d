"""Observability (``repro/obs``): metrics (counters, gauges, log-bucket
histograms), request-lifecycle tracing (Chrome / Perfetto ``trace_event``
JSON) and a retrace watchdog.  Dependency-free; the port keeps its own copy
of the JAX package's modules (``docs/OBSERVABILITY.md`` holds the metric
catalog and the span taxonomy, which both packages share).

``Obs`` is the bundle the engines and ``launch/serve.py`` accept:

    obs = Obs(trace=True, routing=True)      # everything on
    eng = ContinuousEngine(cfg, params, obs=obs, ...)
    ...
    print(obs.metrics.render())
    obs.tracer.export("trace.json")          # load in ui.perfetto.dev

Engines construct a default ``Obs()`` when none is given: metrics on (they
cost microseconds a tick, on the host), the tracer off (one attribute test
per site), per-tick routing statistics off (they add one device-to-host
copy a decode step, so they are an explicit opt-in).  ``Obs.disabled()``
turns the metrics off too: the baseline the default is held against."""
from __future__ import annotations

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.retrace import RetraceWatchdog, jit_cache_size
from repro_torch.obs.trace import Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "RetraceWatchdog", "jit_cache_size", "Tracer", "Obs",
]


class Obs:
    """Bundle of the three instruments plus collection knobs.

    ``routing=True`` makes the engines' decode steps return per-layer
    ``RoutingStats`` (per-expert token counts, dropped share, gate entropy,
    f·P imbalance), copied to the host once a step and summarised there
    (paper §3 / §5: expert load balance is THE MoE-specific signal)."""

    def __init__(self, metrics: MetricsRegistry = None, tracer: Tracer = None,
                 watchdog: RetraceWatchdog = None, routing: bool = False,
                 trace: bool = False):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=trace)
        self.watchdog = watchdog if watchdog is not None else RetraceWatchdog()
        self.routing = routing

    @classmethod
    def disabled(cls) -> "Obs":
        """Everything off, registry included: the baseline."""
        return cls(metrics=MetricsRegistry(enabled=False),
                   tracer=Tracer(enabled=False),
                   watchdog=_InertWatchdog(), routing=False)


class _InertWatchdog(RetraceWatchdog):
    """Watchdog that never samples (the ``Obs.disabled`` baseline)."""

    def register(self, name, fn, aux=False):  # noqa: D102
        pass

    def tick(self) -> int:  # noqa: D102
        return 0
