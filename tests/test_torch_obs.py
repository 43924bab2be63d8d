"""Port parity for observability (``repro_torch/obs`` and its wiring into
both engines, the speculative tick and the serving CLI), against the JAX
package's ``repro.obs`` and engines on the CPU:

  * the framework-free classes fed the same observations: histogram
    percentiles, snapshots, renders and JSON lines equal; trace events equal
    up to their timestamps; the watchdog's accounting over the same fake
    compiled functions equal, and inactive with none registered;
  * a reduced llama4-maverick ``ContinuousEngine`` trace (grouped, paged,
    prefix sharing, a pool small enough to preempt) against JAX's engine on
    the same params, JAX on its kernel path (an idle row's attention is 0
    there, as in the port; its CPU oracle path averages, and an idle row's
    routing would differ): tokens, every counter but ``serve.retraces``
    (JAX counts its compiles), every histogram's observation count, the
    deterministic gauges, each tick's model-step calls, the span names (and
    arguments) per track in order, and each decode tick's routing summary:
    ``tokens_per_expert`` exactly, dropped share and imbalance within 1e-6,
    entropy within 1e-5;
  * the static ``Engine``: ``last_routing``, counters, histogram counts and
    spans against JAX's;
  * a speculative engine (recurrentgemma, a low-accept drafter that resyncs)
    against JAX's speculative engine: every counter, ``spec.*`` included,
    histogram counts and spans per track;
  * ``Obs.disabled()`` leaves the tokens unchanged and records nothing;
  * ``--trace-out``, ``--metrics-out`` and ``--obs-routing`` write a loadable
    trace and a JSON line whose numbers are the printed ones;
  * the port's watchdog is inactive and ``serve.retraces`` is 0.
"""
import functools
import json

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import attention as jattn
from repro.models import model as jm
from repro.serving import continuous as jcontinuous
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Engine as JaxStaticEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.launch import serve as tserve
from repro_torch.serving import continuous as tcontinuous
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, EngineConfig, Request
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

MOD = {"jax": jobs, "torch": tobs}
# the gauges a run sets the same way in both engines (the routing ones are
# held per tick below)
GAUGES = ("serve.active_slots", "serve.queue_depth", "serve.free_pages", "serve.page_occupancy",
          "serve.peak_page_occupancy", "serve.shared_pages", "serve.jitted_calls_per_tick")
ROUTING_TOL = {"dropped_frac": 1e-6, "imbalance": 1e-6, "entropy": 1e-5}


@functools.lru_cache(maxsize=None)
def pair(name, seed=0, moe_impl=None):
    """(JAX cfg, port cfg, JAX params, port params) of a reduced arch from
    ``PRNGKey(seed)``, the port's converted from the JAX tree."""
    jcfg = jax_make_reduced(jax_get_config(name))
    tcfg = make_reduced(get_config(name))
    if moe_impl:
        jcfg, tcfg = jcfg.replace(moe_impl=moe_impl), tcfg.replace(moe_impl=moe_impl)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def llama4():
    return pair("llama4-maverick-400b-a17b", 0, "grouped")


# ---------------------------------------------------------------------------
# The framework-free classes, fed the same observations
# ---------------------------------------------------------------------------


SAMPLES = {
    "uniform": np.linspace(0.01, 1.0, 2000),
    "exponential": np.random.default_rng(0).exponential(0.05, 3000),
    "tails": np.array([0.0, 1e-7, 1e-5, 0.01, 0.2, 5.0, 40.0, 150.0]),
}


@pytest.mark.parametrize("sample", list(SAMPLES))
def test_histogram_percentiles_and_snapshot_equal(sample):
    hists = {k: m.Histogram("t", lo=1e-4, hi=100.0, n_buckets=64) for k, m in MOD.items()}
    for v in SAMPLES[sample]:
        for h in hists.values():
            h.observe(float(v))
    j, t = hists["jax"], hists["torch"]
    assert t.bounds == j.bounds and t.counts == j.counts
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert t.percentile(q) == j.percentile(q)
    assert t.snapshot() == j.snapshot()


def fill_registry(M):
    M.counter("serve.decode_tokens", unit="tok").inc(7)
    M.counter("serve.preemptions").inc()
    M.counter("spec.accepted_tokens", unit="tok").inc(2.5)
    M.gauge("serve.free_pages").set(12)
    M.gauge("routing.entropy", unit="nat").set(1.2345678)
    M.gauge("serve.unset")
    for v in (0.001, 0.002, 0.5):
        M.histogram("serve.ttft_s").observe(v)
    M.histogram("serve.preempts_per_req", unit="", lo=1.0, hi=1024.0, n_buckets=10).observe(0)
    M.histogram("serve.empty_s")


def test_registry_snapshot_render_jsonl_equal(tmp_path):
    regs = {k: m.MetricsRegistry() for k, m in MOD.items()}
    for M in regs.values():
        fill_registry(M)
    j, t = regs["jax"], regs["torch"]
    assert t.snapshot() == j.snapshot()
    assert t.render(prefix="  ") == j.render(prefix="  ")
    rows = {}
    for k, M in regs.items():
        path = tmp_path / f"{k}.jsonl"
        M.write_jsonl(str(path), extra={"arch": "x"})
        rows[k] = json.loads(path.read_text())
        del rows[k]["ts"]
    assert rows["torch"] == rows["jax"]
    for M in regs.values():
        M.reset_all()
    assert t.snapshot() == j.snapshot()
    off = {k: m.MetricsRegistry(enabled=False) for k, m in MOD.items()}
    for M in off.values():
        fill_registry(M)
    assert off["torch"].snapshot() == off["jax"].snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


def drive_tracer(tr):
    tr.begin(("engine", 0), "tick", args={"tick": 1})
    tr.instant(("request", 3), "prefix_hit", args={"tokens": 8})
    tr.begin(("slot", 1), "req3")
    tr.begin(("slot", 1), "chunk[0:8)", args={"rid": 3})
    tr.end(("slot", 1))
    tr.end(("engine", 0), args={"decoded": 2})
    tr.end(("engine", 0))  # a stray end
    tr.instant(("engine", 0), "preempt", args={"rid": 3, "slot": 1})
    with tr.span(("request", 3), "decode"):
        pass
    tr.begin(("request", 4), "queued")  # left open: export closes it


def strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_trace_events_equal_up_to_timestamps(tmp_path):
    tracers = {k: m.Tracer() for k, m in MOD.items()}
    for tr in tracers.values():
        drive_tracer(tr)
    j, t = tracers["jax"], tracers["torch"]
    assert t.n_events == j.n_events
    assert strip_ts(t.trace_events(close_open=False)) == strip_ts(j.trace_events(close_open=False))
    assert strip_ts(t.trace_events()) == strip_ts(j.trace_events())
    docs = {}
    for k, tr in tracers.items():
        path = tmp_path / f"{k}.json"
        tr.export(str(path))
        docs[k] = json.loads(path.read_text())
    assert strip_ts(docs["torch"]["traceEvents"]) == strip_ts(docs["jax"]["traceEvents"])
    assert docs["torch"]["displayTimeUnit"] == docs["jax"]["displayTimeUnit"] == "ms"
    off = tobs.Tracer(enabled=False)
    drive_tracer(off)
    assert off.n_events == 0 and off.trace_events() == []


class _FakeCompiled:
    """A callable whose ``_cache_size`` the test sets."""

    def __init__(self):
        self.n = 0

    def _cache_size(self):
        return self.n


def test_watchdog_accounting_equal():
    warned = {k: [] for k in MOD}
    dogs = {k: m.RetraceWatchdog(steady_after=2, warn_fn=warned[k].append) for k, m in MOD.items()}
    fns = {k: (_FakeCompiled(), _FakeCompiled()) for k in MOD}
    for k, wd in dogs.items():
        wd.register("decode", fns[k][0])
        wd.register("prefill", fns[k][1], aux=True)
    # warm-up compiles, a steady run, then a late prefill (aux) and a decode retrace
    script = [(1, 1), (0, 1), (0, 0), (0, 0), (0, 2), (1, 0), (0, 0)]
    for dd, dp in script:
        got = []
        for k, wd in dogs.items():
            fns[k][0].n += dd
            fns[k][1].n += dp
            got.append(wd.tick())
        assert got[0] == got[1]
    assert dogs["torch"].snapshot() == dogs["jax"].snapshot()
    assert dogs["torch"].registry() == dogs["jax"].registry()
    assert len(warned["torch"]) == len(warned["jax"]) == 1
    assert dogs["torch"].steady_retraces == 1


def test_watchdog_inactive_without_a_compiled_function():
    """The port registers nothing: the watchdog says inactive from the start
    (the JAX copy's starting value is True until a tick finds no cache), and
    an object without a cache size leaves it inactive in both."""
    wd = tobs.RetraceWatchdog()
    assert wd.snapshot()["active"] is False and wd.tick() == 0
    for m in MOD.values():
        wd = m.RetraceWatchdog()
        wd.register("f", object())
        assert wd.tick() == 0 and wd.active is False
    inert = tobs.Obs.disabled().watchdog
    inert.register("f", _FakeCompiled())
    assert inert.tick() == 0 and inert.registry() == {}


# ---------------------------------------------------------------------------
# The engines against JAX's
# ---------------------------------------------------------------------------


def spans_by_track(tracer) -> dict:
    """{(group, id): [(phase, name, args), ...]} in the order recorded: the
    begin / end / instant events of each track (metadata dropped)."""
    out = {}
    for e in tracer.trace_events(close_open=False):
        if e["ph"] == "M":
            continue
        out.setdefault((e["cat"], e["tid"]), []).append((e["ph"], e["name"], e.get("args")))
    return out


def hist_counts(snap) -> dict:
    return {n: h["count"] for n, h in snap["histograms"].items()}


def counters(snap) -> dict:
    return {n: v for n, v in snap["counters"].items() if n != "serve.retraces"}


def assert_routing_close(got, want):
    assert got["moe_layers"] == want["moe_layers"]
    assert list(got["per_layer"]) == list(want["per_layer"])
    for layer, w in want["per_layer"].items():
        g = got["per_layer"][layer]
        assert g["tokens_per_expert"] == w["tokens_per_expert"], layer
        for key, tol in ROUTING_TOL.items():
            assert abs(g[key] - w[key]) <= tol, (layer, key, g[key], w[key])
    for key, tol in ROUTING_TOL.items():
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])


def record_routing(monkeypatch, module, into):
    real = module.summarize_routing

    def rec(tree):
        into.append(real(tree))
        return into[-1]

    monkeypatch.setattr(module, "summarize_routing", rec)


# a shared 8-token preamble (two pages of 4): the second prompt's admission
# shares it; 3 slots of 20 over 9 pages preempt
PRE = [7, 3, 11, 5, 2, 19, 23, 29]
CONT_PROMPTS = [PRE + [31, 37], PRE + [41, 43], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
                [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]]
CONT = dict(slots=3, capacity=20, paged=True, page_size=4, n_pages=9, prefill_chunk=8,
            prefix_sharing=True)


def serve_trace(eng, req, prompts, n_new):
    ids = [eng.submit(req(prompt=p, max_new_tokens=n_new)) for p in prompts]
    done = eng.run_until_done()
    return [done[i].tokens for i in ids]


def test_continuous_engine_obs_matches_jax(monkeypatch):
    jcfg, tcfg, jparams, tparams = llama4()
    seen = {"jax": [], "torch": []}
    record_routing(monkeypatch, jcontinuous, seen["jax"])
    record_routing(monkeypatch, tcontinuous, seen["torch"])
    tob = tobs.Obs(trace=True, routing=True)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", obs=tob, **CONT)
    tt = serve_trace(teng, Request, CONT_PROMPTS, 5)
    job = jobs.Obs(trace=True, routing=True)
    jattn.set_paged_backend("kernel")
    try:
        jeng = JaxEngine(jcfg, jparams, obs=job, **CONT)
        jt = serve_trace(jeng, JaxRequest, CONT_PROMPTS, 5)
    finally:
        jattn.set_paged_backend(None)
    assert tt == jt
    assert teng.preemptions == jeng.preemptions >= 1 and teng.prefix_hits == jeng.prefix_hits >= 1
    ts, js = tob.metrics.snapshot(), job.metrics.snapshot()
    assert counters(ts) == counters(js)
    assert ts["counters"]["serve.retraces"] == 0 and not tob.watchdog.snapshot()["active"]
    assert hist_counts(ts) == hist_counts(js)
    assert ts["histograms"]["serve.tick_s"]["count"] == len(teng.metrics_log)
    assert {g: ts["gauges"][g] for g in GAUGES} == {g: js["gauges"][g] for g in GAUGES}
    # the attributes chip_smoke reads agree with the counters
    assert ts["counters"]["serve.preemptions"] == teng.preemptions
    assert ts["counters"]["serve.prefill_tokens_computed"] == teng.prefill_tokens_total
    assert [m["jitted_calls"] for m in teng.metrics_log] == [m["jitted_calls"]
                                                             for m in jeng.metrics_log]
    assert spans_by_track(tob.tracer) == spans_by_track(job.tracer)
    assert len(seen["torch"]) == len(seen["jax"]) == sum(
        1 for m in jeng.metrics_log if m["tokens_this_tick"])
    for got, want in zip(seen["torch"], seen["jax"]):
        assert_routing_close(got, want)
    assert [m.get("routing", {}).get("moe_layers") for m in teng.metrics_log] == [
        m.get("routing", {}).get("moe_layers") for m in jeng.metrics_log]


STATIC_REQS = [[1, 2, 3, 4, 5, 6], [7, 8, 9], [10, 11, 12, 13, 14]]


def test_static_engine_obs_matches_jax():
    jcfg, tcfg, jparams, tparams = llama4()
    tob, job = tobs.Obs(trace=True, routing=True), jobs.Obs(trace=True, routing=True)
    teng = Engine(tcfg, tparams, EngineConfig(max_batch=2, max_prefill=8, max_decode=5), obs=tob,
                  device="cpu")
    jeng = JaxStaticEngine(jcfg, jparams, JaxEngineConfig(max_batch=2, max_prefill=8,
                                                          max_decode=5), obs=job)
    tout = teng.generate([Request(p, 5) for p in STATIC_REQS])
    jout = jeng.generate([JaxRequest(p, 5) for p in STATIC_REQS])
    assert [r.tokens for r in tout] == [r.tokens for r in jout]
    assert_routing_close(teng.last_routing, jeng.last_routing)
    ts, js = tob.metrics.snapshot(), job.metrics.snapshot()
    assert counters(ts) == counters(js) and ts["counters"]["serve.retraces"] == 0
    assert hist_counts(ts) == hist_counts(js) == {"serve.batch_prefill_s": 2,
                                                  "serve.decode_step_s": 8}
    for g in ("routing.dropped_frac", "routing.entropy", "routing.imbalance"):
        assert abs(ts["gauges"][g] - js["gauges"][g]) <= 1e-5
    assert spans_by_track(tob.tracer) == spans_by_track(job.tracer)


def test_spec_engine_obs_matches_jax():
    """recurrentgemma (RG-LRU and rings: the committed recurrent-state pass
    runs every verify tick) with a seed-1 drafter, whose partial accepts
    roll pages back and resync it."""
    jcfg, tcfg, jparams, tparams = pair("recurrentgemma-2b", 0)
    _, _, jdparams, tdparams = pair("recurrentgemma-2b", 1)
    # pages of 2: a rejected draft leaves a window page to roll back
    kw = dict(slots=3, capacity=64, paged=True, page_size=2, spec_k=3)
    prompts = [[5, 9, 2, 33, 17, 8, 41, 3], [12, 7, 7, 30, 1, 22, 9, 14]]
    tob, job = tobs.Obs(trace=True), jobs.Obs(trace=True)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", spec_draft=(tcfg, tdparams), obs=tob, **kw)
    jeng = JaxEngine(jcfg, jparams, spec_draft=(jcfg, jdparams), obs=job, **kw)
    assert serve_trace(teng, Request, prompts, 5) == serve_trace(jeng, JaxRequest, prompts, 5)
    ts, js = tob.metrics.snapshot(), job.metrics.snapshot()
    assert counters(ts) == counters(js)
    c = ts["counters"]
    assert c["spec.rolled_back_pages"] > 0 and c["spec.draft_resyncs"] > 0
    assert c["spec.accepted_tokens"] < c["spec.draft_tokens"]
    assert c["spec.draft_resyncs"] == teng.spec_resyncs
    assert hist_counts(ts) == hist_counts(js)
    assert spans_by_track(tob.tracer) == spans_by_track(job.tracer)
    with pytest.raises(ValueError, match="routing"):
        ContinuousEngine(tcfg, tparams, device="cpu", spec_draft=(tcfg, tdparams),
                         obs=tobs.Obs(routing=True), **kw)


# ---------------------------------------------------------------------------
# The port alone: the disabled baseline, the watchdog, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["chunked", "batched"])
def test_disabled_obs_leaves_tokens_and_records_nothing(mode):
    _, tcfg, _, tparams = llama4()
    runs = {}
    for name, obs in (("disabled", tobs.Obs.disabled()), ("default", None),
                      ("full", tobs.Obs(trace=True, routing=True))):
        eng = ContinuousEngine(tcfg, tparams, device="cpu", obs=obs, prefill_mode=mode, **CONT)
        runs[name] = (serve_trace(eng, Request, CONT_PROMPTS, 6), eng)
    assert runs["disabled"][0] == runs["default"][0] == runs["full"][0]
    off = runs["disabled"][1].obs
    assert off.metrics.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert off.tracer.n_events == 0 and off.watchdog.tick() == 0
    assert runs["default"][1].obs.tracer.n_events == 0
    assert runs["default"][1].obs.metrics.snapshot()["counters"]["serve.requests_completed"] == 4
    # the model-step calls and ticks do not depend on the instruments
    for name in ("default", "full"):
        assert [m["jitted_calls"] for m in runs[name][1].metrics_log] == [
            m["jitted_calls"] for m in runs["disabled"][1].metrics_log]
    st = {}
    for name, obs in (("disabled", tobs.Obs.disabled()), ("full", tobs.Obs(routing=True))):
        eng = Engine(tcfg, tparams, EngineConfig(max_batch=2, max_prefill=8, max_decode=5),
                     obs=obs, device="cpu")
        st[name] = [r.tokens for r in eng.generate([Request(p, 5) for p in STATIC_REQS])]
        assert (eng.last_routing is None) == (name == "disabled")
    assert st["disabled"] == st["full"]


def test_watchdog_inactive_and_no_retraces_in_the_port_engines():
    _, tcfg, _, tparams = llama4()
    obs = tobs.Obs()
    eng = ContinuousEngine(tcfg, tparams, device="cpu", obs=obs, **CONT)
    serve_trace(eng, Request, CONT_PROMPTS[:2], 4)
    Engine(tcfg, tparams, EngineConfig(max_batch=2, max_prefill=8, max_decode=3), obs=obs,
           device="cpu").generate([Request(STATIC_REQS[0], 3)])
    snap = obs.watchdog.snapshot()
    assert snap == {"active": False, "total_compiles": 0, "steady": False, "steady_retraces": 0,
                    "per_fn": {}}
    assert obs.metrics.snapshot()["counters"]["serve.retraces"] == 0
    assert all(m["retraces"] == 0 for m in eng.metrics_log)


def printed_matches(out: str, row: dict) -> None:
    """Every counter and histogram of the JSON line appears, with the same
    numbers, in the printed render."""
    for n, v in row["counters"].items():
        assert (f"{n}={v:g}" if isinstance(v, float) else f"{n}={v}") in out, n
    for n, v in row["gauges"].items():
        assert f"{n}={v:.4g}" in out, n
    for n, h in row["histograms"].items():
        if h["count"]:
            u = h["unit"]
            assert (f"{n}: n={h['count']} mean={h['mean']:.4g}{u} p50={h['p50']:.4g}{u} "
                    f"p95={h['p95']:.4g}{u} p99={h['p99']:.4g}{u}") in out, n


@pytest.mark.parametrize("flags", [[], ["--paged", "--page-size", "4", "--pages", "8", "--slots",
                                        "2", "--prefill-chunk", "8"]], ids=["static", "paged"])
def test_cli_obs_flags(capsys, tmp_path, flags):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    tserve.main(["--arch", "llama4-maverick-400b-a17b", "--reduced", "--moe-impl", "grouped",
                 "--device", "cpu", "--requests", "3", "--batch", "2", "--prompt-len", "6",
                 "--new-tokens", "4", "--trace-out", str(trace), "--metrics-out", str(metrics),
                 "--obs-routing", *flags])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert ({"tick", "queued", "prefill", "decode", "complete"} <= names if flags
            else {"prefill", "decode"} <= names)
    assert f"trace ({len(doc['traceEvents'])} events)" in out
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["arch"] == "llama4-maverick-400b-a17b"
    assert rows[0]["paged"] == bool(flags) and rows[0]["tokens"] == 12
    # the warm-up's samples were dropped: one window of 3 requests
    assert rows[0]["counters"]["serve.decode_tokens"] == (9 if flags else 12)
    assert "routing.entropy" in rows[0]["gauges"]
    printed_matches(out, rows[0])


def test_cli_obs_routing_refused_with_speculation(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "glm4-9b", "--reduced", "--device", "cpu", "--paged",
                     "--spec-draft", "self", "--obs-routing"])
    assert "--obs-routing is incompatible with --spec-draft" in capsys.readouterr().err
