"""The port's analysis suite (``repro_torch.analysis``, ``launch/op_account``
and ``launch/roofline``) against the JAX package's (``repro.analysis``,
``repro.launch.hlo_account``, ``repro.launch.roofline``) where the two
compute the same thing, and on its own terms where the port's step is eager:

* lint: each of the six rules tripped exactly once by a torch fixture, a
  clean fixture, a pragma that suppresses but stays visible, the severity
  map; ``PRAGMA_RE`` / ``_pragmas`` give JAX's results on the same strings;
  ``lint_tree`` parses every file of ``src/repro_torch``;
* contracts: the chunk arithmetic and ``predict_compiles`` equal JAX's
  exactly over a grid; the distinct step signatures a reduced glm4-9b
  ``ContinuousEngine`` calls (chunked, batched, speculative) equal the
  prediction; the declared contract runs and closes;
* graph: stray collectives (a raw ``c10d`` op and a ``collectives.py``
  call in a one-rank gloo group), a clean step, dtype drift, the capacity
  arithmetic equal to JAX's, a kernel entry hiding its plain version;
* in place: a decode step keeps every cache's storage, a reallocating one
  is caught;
* account: ``model_flops`` equal to JAX's for every assigned arch x shape;
  a reduced dense arch's matmul operations against the dot FLOPs of JAX's
  ``hlo_account`` over the same step's HLO on the CPU (decode exactly; the
  prefill exactly once the dense attention dots JAX computes are added:
  the port's kernel 6 counts only unmasked pairs); gathers and in-place
  scatters counted by the rows they move, exactly as counted by hand; a
  reduced decode step's vocabulary-dependent bytes exactly the
  unembedding read once and the logits written once (the embedding lookup
  reads its rows, not the table); the kernel formulas at PERF.md §6's
  recorded shapes within 1%.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401

from repro_torch.analysis import contracts as tc
from repro_torch.analysis import graph as tg
from repro_torch.analysis import lint as tl
from repro_torch.analysis.donation import audit_inplace, leaves
from repro_torch.configs.registry import ASSIGNED, get_config, make_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.model import init_params

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")

# ---------------------------------------------------------------------------
# Lint
# ---------------------------------------------------------------------------

HEAD = "import torch\n\n\ndef step(x: torch.Tensor, n: int):\n    y = torch.exp(x)\n"
FIXTURES = {
    "host-item": HEAD + "    return y.sum().item()\n",
    "host-cast": HEAD + "    return int(y.sum())\n",
    "host-asarray": HEAD + "    return y.cpu()\n",
    "tracer-branch": HEAD + "    if y.sum() > 0:\n        return y\n    return -y\n",
    "debug-call": HEAD + "    print(y)\n    return y\n",
    "block-sync": HEAD + "    torch.cuda.synchronize()\n    return y\n",
}
CLEAN = HEAD + """    if x.shape[0] > n and y.numel() and x.dtype == torch.float32:
        y = y[: x.size(0)]
    if x is not None and isinstance(x, torch.Tensor):
        z = torch.from_numpy(np.zeros(3)) if x.device.type == "cpu" else y
    up = torch.from_numpy(np.zeros(4)).pin_memory().to(x.device, non_blocking=True)
    return int(x.shape[1]), float(n), y, z, up
"""
PRAGMA = HEAD + ("    # analysis: allow(host-asarray) — the step's result, read back once\n"
                 "    return y.cpu()\n")
UPLOAD = HEAD + "    buf = torch.from_numpy(np.zeros(4))\n    return buf.to(x.device)\n"


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_fixture_trips_exactly_one_rule(rule):
    rep = tl.lint_source(FIXTURES[rule], "models/fixture.py")
    assert [f.rule for f in rep.active()] == [rule], rep.render()
    assert rep.active()[0].severity == "error"


def test_clean_fixture_trips_nothing():
    rep = tl.lint_source(CLEAN, "models/fixture.py")
    assert not rep.findings, rep.render()


def test_pragma_suppresses_but_stays_visible():
    rep = tl.lint_source(PRAGMA, "serving/fixture.py")
    assert not rep.active(), rep.render()
    assert [f.rule for f in rep.findings] == ["host-asarray"]
    assert rep.findings[0].suppressed


def test_pageable_upload_is_a_sync():
    """The torch twin of a read-back: a pageable host tensor's ``.to(dev)``
    waits for the stream (``host-asarray``), at the line of ``.to``."""
    rep = tl.lint_source(UPLOAD, "serving/fixture.py")
    assert [(f.rule, f.location) for f in rep.active()] == \
        [("host-asarray", "serving/fixture.py:7")]


def test_severity_follows_module_map():
    src = FIXTURES["host-cast"]
    assert tl.lint_source(src, "serving/x.py").errors
    cold = tl.lint_source(src, "launch/x.py")
    assert not cold.errors and [f.rule for f in cold.warnings] == ["host-cast"]
    # tracer-branch only applies to the traced layers; serving hosts the
    # scheduler (Python control flow on host state is its job)
    assert not tl.lint_source(FIXTURES["tracer-branch"], "serving/x.py").findings
    assert tl.lint_source(FIXTURES["tracer-branch"], "kernels/x.py").errors


@pytest.mark.parametrize("text", [
    "x = 1  # analysis: allow(host-item) — why",
    "# analysis: allow(host-cast, host-asarray) — why\ny = 2",
    "z  # analysis:allow( * )",
    "# analysis: allow(tracer-branch)\n\nw",
    "# not a pragma: allow(host-item)",
])
def test_pragma_parsing_matches_jax(text):
    from repro.analysis import lint as jl

    assert tl.PRAGMA_RE.pattern == jl.PRAGMA_RE.pattern
    assert tl._pragmas(text) == jl._pragmas(text)
    assert tl.RULES == jl.RULES


def test_lint_tree_parses_the_package():
    rep = tl.lint_tree(PKG)
    n = sum(len([f for f in fs if f.endswith(".py")]) for _, _, fs in os.walk(PKG))
    assert rep.metrics["lint.files"] == n
    # the hot modules' active findings are the pageable uploads ROADMAP item
    # 10 lists; every read-back the scheduler needs carries its pragma
    active = [f for f in rep.errors]
    assert active and all(f.rule == "host-asarray" and f.location.startswith("serving/")
                          and "pageable" in f.message for f in active), rep.render()
    assert any(f.suppressed and f.location.startswith("serving/engine.py") for f in rep.findings)


# ---------------------------------------------------------------------------
# Contracts
# ---------------------------------------------------------------------------


def test_chunk_arithmetic_matches_jax():
    from repro.analysis import contracts as jc

    for ctx in (1, 7, 15, 16, 17, 33, 63, 64, 65, 100, 255):
        for start in range(0, ctx, 16):
            for budget in (1, 8, 16, 20, 32, 64):
                assert tc.chunk_lengths(ctx, start, budget, 16) == \
                    jc.chunk_lengths(ctx, start, budget, 16)
    for cap, ps, chunk in ((64, 16, 32), (128, 16, 64), (256, 8, 24)):
        for lens, new in (((5, 20), 4), ((16, 33, 7, 64), 8), ((100,), 30)):
            w, jw = tc.Workload(lens, new, 32), jc.Workload(lens, new, 32)
            assert tc.reachable_chunk_lengths(cap, ps, chunk, w) == \
                jc.reachable_chunk_lengths(cap, ps, chunk, jw)


@pytest.mark.parametrize("mode,spec", [("chunked", None), ("batched", None), ("scatter", None),
                                       ("batched", {"commit_pass": True})])
def test_predict_compiles_matches_jax(mode, spec):
    from repro.analysis import contracts as jc

    for slots, cap, ps, chunk in ((2, 64, 16, 32), (3, 64, 16, 32), (4, 256, 16, 64)):
        for lens, new, ticks, forks in (((5, 20), 4, 32, 0), ((5, 20, 40), 6, 32, 0),
                                        ((16, 16, 16, 16), 236, 47, 0), ((30,), 5, 20, 2)):
            kw = dict(slots=slots, capacity=cap, page_size=ps, prefill_chunk=chunk,
                      prefill_mode=mode, spec=spec)
            assert tc.predict_compiles(workload=tc.Workload(lens, new, ticks, forks), **kw) == \
                jc.predict_compiles(workload=jc.Workload(lens, new, ticks, forks), **kw)


def test_predict_compiles_obs_scenario():
    pred = tc.predict_compiles(slots=4, capacity=256, page_size=16, prefill_chunk=64,
                               workload=tc.Workload((16, 16, 16, 16), 236, 47))
    assert pred == {"decode": 1, "prefill": 0, "prefill_chunk_first": 1,
                    "prefill_chunk_cont": 0, "reset_pages": 0, "copy_slot": 0, "copy_page": 0}


@pytest.fixture(scope="module")
def glm4():
    cfg = make_reduced(get_config("glm4-9b"))
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(glm4, **kw):
    from repro_torch.serving.continuous import ContinuousEngine

    cfg, params = glm4
    return ContinuousEngine(cfg, params, paged=True, page_size=16, prefix_sharing=True,
                            prefill_chunk=32, capacity=64, device="cpu", **kw)


def _observe(eng, lens, new):
    from repro_torch.serving.engine import Request

    with tc.observe_steps() as seen:
        for n in lens:
            eng.submit(Request(prompt=[(i % 50) + 1 for i in range(n)], max_new_tokens=new))
        eng.run_until_done()
    return seen


@pytest.mark.parametrize("case", ["chunked", "batched", "spec"])
def test_predicted_equals_observed_signatures(glm4, case):
    """The prediction equals the distinct signatures the engine calls each
    step function with (JAX: the compile counts its retrace watchdog sees;
    the port: one CUDA graph capture each)."""
    if case == "chunked":
        eng, lens, new, kw = _engine(glm4, slots=2), (5, 20), 4, {}
    elif case == "batched":
        eng, lens, new = _engine(glm4, slots=3, prefill_mode="batched"), (5, 20, 40), 4
        kw = dict(prefill_mode="batched")
    else:
        eng = _engine(glm4, slots=3, prefill_mode="batched", spec_draft=glm4, spec_k=3)
        lens, new = (5, 20, 40), 6
        kw = dict(prefill_mode="batched", spec={"commit_pass": False})
    seen = _observe(eng, lens, new)
    pred = tc.predict_compiles(slots=eng.n_slots, capacity=64, page_size=16, prefill_chunk=32,
                               workload=tc.Workload(lens, new, 32), **kw)
    assert tc.observed_counts(seen, pred) == pred, (seen, pred)
    if case == "spec":
        assert pred["draft_prefill"] == 3 and pred["verify"] == 1 and pred["decode"] == 0


def test_engine_contract_runs_and_closes(glm4):
    eng = _engine(glm4, slots=2)
    entries = tc.engine_contract(eng)
    rep = tc.check_contract(entries)
    tc.check_closure(entries, capacity=64, page_size=16, prefill_chunk=32,
                     workload=tc.Workload((5, 20), 4, 32), report=rep)
    assert not rep.errors, rep.render()
    assert [e.name for e in entries if e.primary] == ["decode"]
    # the closure pass catches a family that leaves out a reachable length
    narrow = [tc.ContractEntry("prefill_chunk_first", None, None, ((16,), (32,)), ())]
    bad = tc.check_closure(narrow, capacity=64, page_size=16, prefill_chunk=32,
                           workload=tc.Workload((7,), 4, 8))
    assert any(f.rule == "contract-escape" for f in bad.errors)


def test_contract_flags_open_and_failing_entries():
    open_ = tc.ContractEntry("decode", lambda x: x + 1, lambda n: (torch.zeros(n),),
                             ((4,), (8,)), ((4,),), primary=True)
    fails = tc.ContractEntry("bad", lambda x: x @ x, lambda: (torch.zeros(3, 4),), ((),), ((),))
    rep = tc.check_contract([open_, fails])
    assert sorted(f.rule for f in rep.errors) == ["contract-open", "contract-trace-failed"]


# ---------------------------------------------------------------------------
# In place
# ---------------------------------------------------------------------------


def test_decode_keeps_cache_storage_and_a_copy_is_caught(glm4):
    from repro_torch.models import model as M

    eng = _engine(glm4, slots=2)
    dec = next(e for e in tc.engine_contract(eng) if e.name == "decode")
    with torch.no_grad():
        rep, _ = audit_inplace("decode", dec.fn, dec.make(), dec.mutated, returns=dec.returns)
    assert not rep.errors, rep.render()
    n = len(leaves(dec.make()[4]))
    assert rep.metrics["inplace.decode.kept"] == f"{n}/{n}"

    def copying(p, t, pos, a, c, tb):
        out = M.paged_ragged_decode_step(eng.cfg, p, t, pos, c, tb, a)
        node = c
        while not any(torch.is_tensor(v) for v in node.values()):
            node = next(v for v in node.values() if isinstance(v, dict))
        k = next(k for k, v in node.items() if torch.is_tensor(v))
        node[k] = node[k].clone()  # a new tensor where the step should write in place
        return out

    with torch.no_grad():
        rep, _ = audit_inplace("copying", copying, dec.make(), (4,), returns={4: 1})
    assert [f.rule for f in rep.errors] == ["inplace-reallocated"]


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_group():
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_stray_collective_detected(one_rank_group):
    import torch.distributed as dist

    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import make_ep_mesh

    mesh = make_ep_mesh((1,), ("data",))

    def step(x):
        y = x * 2
        dist.all_reduce(y)  # a raw c10d op
        return col.psum(y, mesh, "data")  # a collective of the port's schedules

    cap = tg.capture(step, torch.ones(8))
    assert cap.collectives() == {"c10d.allreduce_.default": 1, "psum": 1}, cap.collectives()
    rep = tg.audit_collectives(cap, "step")
    assert [f.rule for f in rep.errors] == ["stray-collective"] * 2
    held = tg.audit_collectives(cap, "ep", allowed={"psum": 1, "c10d.allreduce_.default": 1})
    assert not held.errors
    wrong = tg.audit_collectives(cap, "ep", allowed={"psum": 2, "c10d.allreduce_.default": 1})
    assert [f.rule for f in wrong.errors] == ["collective-count"]


def test_single_device_step_is_clean(glm4):
    eng = _engine(glm4, slots=2)
    dec = next(e for e in tc.engine_contract(eng) if e.name == "decode")
    with torch.no_grad():
        rep = tg.audit_graph("decode", dec.fn, dec.make())
    assert not rep.findings, rep.render()
    assert rep.metrics["graph.decode.kernels"] == {"paged_decode_attention": eng.cfg.num_layers}


def test_dtype_drift_threshold():
    big = torch.ones(64, 128, dtype=torch.int8)
    small = torch.ones(16, dtype=torch.int8)
    pos = torch.arange(8192, dtype=torch.int32)
    rep = tg.audit_dtype_drift(tg.capture(lambda: big.float() * 2), "big")
    assert [f.rule for f in rep.errors] == ["dtype-drift"]
    for fn in (lambda: small.float(), lambda: pos.float() + 1, lambda: big.to(torch.int32)):
        assert not tg.audit_dtype_drift(tg.capture(fn), "ok").findings


def test_capacity_dead_compute_matches_jax():
    from repro.analysis.graph import capacity_dead_compute as jcdc

    for T in (1, 4, 8, 64, 256, 1000):
        for E in (4, 16, 128):
            for K in (1, 2, 8):
                for cf in (0.25, 1.0, 1.25, 2.0):
                    assert tg.capacity_dead_compute(T, E, K, cf) == jcdc(T, E, K, cf)


def test_kernel_entry_hides_plain_ops():
    from repro_torch.kernels import moe_gating as k1

    logits = torch.randn(16, 8)
    plain = tg.capture(lambda: k1.gating_plain(logits, 2, 8))
    assert len(plain.of("aten")) > 5
    cap = tg.capture(lambda: k1._gating(logits, 2, 8, True, True))
    assert [(r.kind, r.name) for r in cap.records] == [("kernel", "moe_gating")]
    assert cap.records[0].args["top_k"] == 2 and cap.records[0].args["logits"].shape == (16, 8)


def test_capacity_cross_check_and_measured_fill():
    """The capacity step's expert buffer is the gating arithmetic's [E, C, D],
    and the measured padded share is 1 - sum(fill) / (E * C)."""
    from repro_torch.models.model import init_caches, prefill

    cfg = make_reduced(get_config("llama4-maverick-400b-a17b"))  # moe_impl "ep": capacity
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    cap = tg.capture(prefill, cfg, params, toks, init_caches(cfg, 2, 16, device="cpu"))
    f = next(ls.ffn for ls in cfg.layer_specs() if ls.ffn.kind == "moe")
    rep = tg.audit_dead_compute(cap, "prefill", num_tokens=16, num_experts=f.num_experts,
                                top_k=f.top_k, capacity_factor=f.capacity_factor, impl="ep")
    assert not rep.errors, rep.render()
    entry = next(r for r in cap.records if r.name == "expert_mlp")
    fill = entry.args["fill"].value.clamp(0, entry.args["xe"].shape[1])
    want = 1 - float(fill.sum()) / (entry.args["xe"].shape[0] * entry.args["xe"].shape[1])
    assert rep.metrics["graph.prefill.padded_fraction_measured"] == pytest.approx(want, abs=0)


# ---------------------------------------------------------------------------
# Account and roofline
# ---------------------------------------------------------------------------


def test_model_flops_matches_jax():
    from repro.configs.registry import get_config as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.launch.roofline import model_flops as jmf

    from repro_torch.launch.roofline import model_flops

    for arch in ASSIGNED:
        for name in SHAPES:
            assert model_flops(get_config(arch), SHAPES[name]) == jmf(jget(arch), JSHAPES[name])


@pytest.mark.parametrize("arch", ["llama3-8b"])
def test_matmul_ops_match_hlo_account(arch):
    """Decode: the port's matmul operations equal the dot FLOPs XLA's HLO of
    JAX's decode step carries, exactly (both run attention as dense products
    over the whole cache).  Prefill: JAX's dots also hold the dense
    attention products (4·B·S·S·H·dh a layer), which the port runs in kernel
    6 and counts by unmasked pairs; with those added the two agree exactly."""
    from repro.configs.registry import get_config as jget
    from repro.configs.registry import make_reduced as jred
    from repro.launch.hlo_account import account as hlo_account
    from repro.models.model import decode_step as jdecode
    from repro.models.model import init_caches as jcaches
    from repro.models.model import init_params as jinit
    from repro.models.model import prefill as jprefill

    from repro_torch.launch.op_account import account
    from repro_torch.models.model import decode_step, init_caches, prefill

    jc, cfg = jred(jget(arch)), make_reduced(get_config(arch))
    B, S, CAP = 2, 16, 32
    jp = jax.eval_shape(lambda: jinit(jc, jax.random.PRNGKey(0)))
    jca = jax.eval_shape(lambda: jcaches(jc, B, CAP))
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    hlo_p = jax.jit(lambda p, t, c: jprefill(jc, p, t, c)).lower(jp, i32(B, S), jca).compile()
    hlo_d = jax.jit(lambda p, t, i, c: jdecode(jc, p, t, i, c)).lower(
        jp, i32(B, 1), i32(), jca).compile()
    params = init_params(cfg, seed=0, device="cpu")
    caches = init_caches(cfg, B, CAP, device="cpu")
    cap_p = tg.capture(prefill, cfg, params, torch.zeros((B, S), dtype=torch.long), caches)
    cap_d = tg.capture(decode_step, cfg, params, torch.zeros((B, 1), dtype=torch.long), S, caches)
    attn = [ls.mixer for ls in cfg.layer_specs() if ls.mixer.__class__.__name__ == "AttnSpec"]
    dense_attn = len(attn) * 4 * B * S * S * cfg.num_heads * cfg.head_dim
    assert account(cap_d).matmul_ops == hlo_account(hlo_d.as_text()).flops
    assert account(cap_p).matmul_ops + dense_attn == hlo_account(hlo_p.as_text()).flops
    assert account(cap_p).kernel_count == {"flash_attention": len(attn)}


def test_gathers_and_scatters_count_the_rows_they_move():
    """Exact hand counts: a gather reads its indices and its selected rows
    and writes them; an in-place scatter reads its indices and values and
    writes (or, adding, reads and writes) the rows they name; a functional
    scatter copies its whole source and is counted whole."""
    import torch.nn.functional as F

    from repro_torch.launch.op_account import account

    table = torch.randn(1000, 64)  # f32: 256 bytes a row
    idx = torch.tensor([3, 7, 7, 900])  # int64: 32 bytes
    ones = torch.ones(4, 64)
    targets = [table.clone() for _ in range(3)]
    rows, ib, whole = 4 * 256, 32, 1000 * 256
    cases = [
        (lambda: table[idx], ib + 2 * rows),
        (lambda: torch.index_select(table, 0, idx), ib + 2 * rows),
        (lambda: F.embedding(idx, table), ib + 2 * rows),
        (lambda: torch.gather(table, 0, idx[:, None].expand(4, 64)), 4 * 64 * 8 + 2 * rows),
        (lambda: targets[0].index_put_((idx,), ones), ib + rows + rows),
        (lambda: targets[1].index_add_(0, idx, ones), ib + rows + 2 * rows),
        (lambda: targets[2].index_put((idx,), ones), 2 * whole + ib + rows),
    ]
    for i, (fn, want) in enumerate(cases):
        cap = tg.capture(fn)
        assert account(cap).traffic == want, (i, [r.name for r in cap.records])


@pytest.mark.parametrize("arch", ["llama3-8b", "llama4-maverick-400b-a17b"])
def test_decode_step_vocab_bytes_by_hand(arch):
    """A decode step's bytes that grow with the vocabulary are the
    unembedding read once and the logits written once: from V = 512 to
    4096 (f32, batch 2) exactly (V2 - V1)·(D + B)·4 bytes.  Counting the
    embedding lookup's whole table would add (V2 - V1)·D·4 more."""
    from repro_torch.launch.op_account import account
    from repro_torch.models.model import decode_step, init_caches

    B, traffic = 2, {}
    for V in (512, 4096):
        cfg = make_reduced(get_config(arch)).replace(vocab_size=V, moe_impl="grouped")
        params = init_params(cfg, seed=0, device="cpu")
        caches = init_caches(cfg, B, 32, device="cpu")
        toks = torch.zeros((B, 1), dtype=torch.long)
        traffic[V] = account(tg.capture(decode_step, cfg, params, toks, 16, caches)).traffic
    assert traffic[4096] - traffic[512] == (4096 - 512) * (cfg.d_model + B) * 4


def _entry_meta(shape, dtype, value=None):
    return tg.TensorMeta(tuple(shape), dtype, value)


def test_kernel_formulas_at_recorded_shapes():
    """PERF.md §6's bounds (NVIDIA H100 80GB HBM3, 700.00 W rates): kernel 4
    at llama4's width (E 128, D 5120, F 8192, bf16) and T = 256 top-1, whose
    256 tokens reached 109 experts (8.194 ms), and kernel 2b at llama4's
    width over 16 experts, T = 2048 at C = 160 (2.424 ms); within 1%."""
    from repro_torch.launch import op_account as oa
    from repro_torch.launch.roofline import HBM_BW, PEAK_OPS

    def bound_ms(fn, a):
        nbytes, ops, dtype = fn(a)
        return max(nbytes / HBM_BW, ops / PEAK_OPS[str(dtype).replace("torch.", "")]) * 1e3

    E, D, F, T, live = 128, 5120, 8192, 256, 109
    counts = [3] * 38 + [2] * 71  # 256 tokens over 109 experts
    assert sum(counts) == T and len(counts) == live
    tiles = sum(-(-c // 8) for c in counts)
    te = torch.tensor([e for e, c in enumerate(counts) for _ in range(-(-c // 8))]
                      + [0] * (tiles + 16 - tiles), dtype=torch.int32)
    w = lambda *s: _entry_meta(s, torch.bfloat16)
    a = {"xg": w((tiles + 16) * 8, D), "te": _entry_meta(te.shape, torch.int32, te),
         "rows_used": _entry_meta((1,), torch.int32, torch.tensor([tiles * 8])),
         "wi": w(E, D, F), "wg": w(E, D, F), "wo": w(E, F, D)}
    assert bound_ms(oa.grouped_mlp, a) == pytest.approx(8.194, rel=0.01)
    E2 = 16
    fill = torch.full((E2,), 128, dtype=torch.int32)
    b = {"xe": w(E2, 160, D), "wi": w(E2, D, F), "wg": w(E2, D, F), "wo": w(E2, F, D),
         "dy": w(E2, 160, D), "fill": _entry_meta((E2,), torch.int32, fill)}
    assert bound_ms(oa.expert_mlp_backward, b) == pytest.approx(2.424, rel=0.01)


def test_roofline_terms():
    from repro_torch.launch.op_account import Account
    from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, analyze

    acct = Account(ops_by_dtype={"bfloat16": 989e12, "float32": 67e12}, traffic=3.35e12,
                   coll_bytes={"all_to_all": 450e9}, coll_count={"all_to_all": 1})
    r = analyze(acct, chips=1)
    assert r.t_compute == pytest.approx(2.0) and r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(450e9 / NVLINK_BW) and r.dominant == "compute"
    assert r.as_dict()["card"] == "NVIDIA H100 80GB HBM3, 700.00 W" and HBM_BW == 3.35e12
