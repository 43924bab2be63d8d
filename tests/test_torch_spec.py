"""Port parity for speculative decoding (``repro_torch/serving/spec.py`` and
``ContinuousEngine._spec_decode_tick``, the cases of ``tests/test_spec.py``)
on reduced configs in f32 on the CPU, the kernels on their plain versions:

  * ``accept_length`` on both copies; the constructor's refusals;
  * the port's speculative engine against the port's non-speculative engine
    on reduced glm4-9b (dense) and reduced llama4 under dropless grouped
    dispatch, for a self drafter, a seed-1 drafter, an int8 pool, chunked
    and batched prefill, prefix sharing and ``submit_n`` forks, k = 1, k = 6
    across 4-token pages, the budget clamp, EOS mid-window, a starved pool
    and four fixed-seed rollback cases built like JAX's fuzz (seed 631
    among them).  Fixed seeds only: a Hypothesis draw of the JAX fuzz can
    fail on the reference side (ROADMAP.md queue 3);
  * the port's speculative engine against the JAX speculative engine (the
    paper's pairing, nlg-350m drafting for nlg-350m-moe128 under its own
    capacity dispatch; glm4-9b with a low-accept drafter; llama4 under its
    own capacity dispatch): tokens and every tick's ``spec`` record;
  * ``paged_verify_chunk_batched`` and ``paged_reset_page_tails`` against
    JAX's; the tail invariant after partial accepts;
  * the archs with per-slot state (the gemma3 and recurrentgemma cases of
    ``tests/test_spec.py``, and mamba2): a self drafter, a low-accept drafter
    (whose partial accepts resync a recurrent drafter), prefix sharing, and
    cross-family pairs against the port's non-speculative engine; gemma3
    over an int8 pool and a recurrentgemma low-accept run against the JAX
    speculative engine (tokens and every tick's ``spec`` record, resyncs
    included); the committed recurrent-state pass leaves every pool page
    byte-identical and advances the per-slot leaves.

Tolerances: greedy tokens, ``spec`` records, preemption counts and CoW
copies are exact, pools drain (``check()``, every page free, an empty prefix
index); verify logits within 1e-5 (absolute and relative, the batched
prefill's); reset positions exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import attention as jattn
from repro.models import model as jm
from repro.serving import spec as jspec
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models.model import init_params
from repro_torch.serving import spec as tspec
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Request
from test_torch_batched_prefill import assert_pools_close
from test_torch_prefix import PRE, copy_into, leaves_like
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-5)
PAGED = dict(slots=3, capacity=64, paged=True, page_size=4)
ARCHS = {"glm4": ("glm4-9b", None), "llama4_grouped": ("llama4-maverick-400b-a17b", "grouped")}
# the archs with per-slot state beside (or instead of) the pool
MIXED = {"gemma3": ("gemma3-27b", None), "recurrentgemma": ("recurrentgemma-2b", None),
         "mamba2": ("mamba2-370m", None)}


@functools.lru_cache(maxsize=None)
def port_setup(key):
    """Reduced config, target params (seed 0) and drafter params (seed 1),
    drawn by the port on the CPU."""
    name, moe_impl = {**ARCHS, **MIXED}[key]
    cfg = make_reduced(get_config(name))
    if moe_impl:
        cfg = cfg.replace(moe_impl=moe_impl)
    return cfg, init_params(cfg, seed=0, device="cpu"), init_params(cfg, seed=1, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_pair(name, seed=0, moe_impl=None):
    """(JAX cfg, port cfg, JAX params, port params) of a reduced arch from
    ``PRNGKey(seed)``, the port's converted from the JAX tree."""
    jcfg = jax_make_reduced(jax_get_config(name))
    tcfg = make_reduced(get_config(name))
    if moe_impl:
        jcfg, tcfg = jcfg.replace(moe_impl=moe_impl), tcfg.replace(moe_impl=moe_impl)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def prompts_of(n=3, lo=3, hi=12, seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).tolist() for _ in range(n)]


def serve(eng, req, prompts, n_new, n_samples=1):
    if n_samples > 1:
        ids = [rid for p in prompts for rid in eng.submit_n(req(prompt=p, max_new_tokens=n_new),
                                                             n_samples)]
    else:
        ids = [eng.submit(req(prompt=p, max_new_tokens=n_new)) for p in prompts]
    done = eng.run_until_done()
    return [done[i].tokens for i in ids]


def spec_records(eng):
    return [m["spec"] for m in eng.metrics_log if "spec" in m]


def assert_drained(eng):
    eng.pool.check()
    assert eng.pool.free_count == eng.n_pages, "leaked fork pages"
    if eng.prefix is not None:
        assert len(eng.prefix) == 0, "prefix index not fully evicted"


# ---------------------------------------------------------------------------
# accept_length and the constructor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [jspec, tspec], ids=["jax", "torch"])
def test_accept_length_rule(mod):
    g = [5, 6, 7, 8, 9]
    assert mod.accept_length([], g) == 0
    assert mod.accept_length([5, 6, 7], g) == 3  # full accept
    assert mod.accept_length([5, 6, 0], g) == 2
    assert mod.accept_length([0, 6, 7], g) == 0  # the first token already wrong
    assert mod.accept_length([5, 0, 7], g) == 1  # agreement after a mismatch ignored


REFUSALS = {
    "unpaged": (dict(paged=False), "paged"),
    "sampling": (dict(temperature=0.7), "greedy"),
    "vocab": (dict(vocab=1), "vocab"),
    "k0": (dict(spec_k=0), "spec_k"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_spec_constructor_refusals(case):
    cfg, params, _ = port_setup("glm4")
    kw, match = REFUSALS[case]
    kw = dict(PAGED, **kw)
    dcfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + kw.pop("vocab", 0))
    kw.setdefault("spec_k", 3)
    with pytest.raises(ValueError, match=match):
        ContinuousEngine(cfg, params, device="cpu", spec_draft=(dcfg, params), **kw)


# ---------------------------------------------------------------------------
# The port's speculative engine against its non-speculative engine
# ---------------------------------------------------------------------------


def fuzz_case(seed, vocab):
    """A case built as JAX's rollback fuzz draws one: 6 prompts of 1-13
    tokens, 4-15 new tokens, k 1-4, a pool of 12-19 pages of 4 for 3 slots
    of capacity 32, prefix sharing on or off."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(1, 14))).tolist() for _ in range(6)]
    n_new = int(rng.integers(4, 16))
    k = int(rng.integers(1, 5))
    kw = dict(slots=3, capacity=32, page_size=4, n_pages=int(rng.integers(12, 20)),
              prefix_sharing=bool(rng.integers(0, 2)))
    return prompts, n_new, k, kw


# name -> (drafter "self" or "seed1", k, n_new, engine options, prompts, n_samples)
CASES = {
    "self_oracle": ("self", 3, 10, {}, None, 1),
    "low_accept": ("seed1", 3, 10, {}, None, 1),
    "int8_pool": ("seed1", 3, 8, dict(kv_cache_bits=8), None, 1),
    "chunked": ("seed1", 3, 9, dict(prefill_mode="chunked", slots=2), "four", 1),
    "batched": ("seed1", 3, 9, dict(prefill_mode="batched", slots=2), "four", 1),
    "prefix_sharing": ("seed1", 3, 9, dict(prefix_sharing=True), "preamble", 1),
    "submit_n_forks": ("seed1", 3, 9, dict(prefix_sharing=True), "fork", 3),
    "k1": ("seed1", 1, 8, {}, None, 1),
    "k6_across_pages": ("seed1", 6, 14, {}, None, 1),
    "budget_1": ("seed1", 4, 1, {}, None, 1),
    "budget_2": ("seed1", 4, 2, {}, None, 1),
    "budget_3": ("seed1", 4, 3, {}, None, 1),
    "eos_mid_window": ("self", 3, 10, dict(eos_id="probe"), None, 1),
    "starved_pool": ("seed1", 3, 12, dict(capacity=32, n_pages=14), "five", 1),
    **{f"fuzz_seed{s}": ("seed1", "fuzz", s, {}, None, 1) for s in (631, 0, 1, 2)},
}


def case_prompts(which):
    return {None: prompts_of(), "four": prompts_of(n=4), "five": prompts_of(n=5, seed=3),
            "preamble": [PRE + [11, 12], PRE + [11, 12], PRE + [13]],
            "fork": [PRE + [11, 12]]}[which]


def jax_tree(params) -> dict:
    """A port parameter tree (full precision) as the JAX package's."""
    return {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else jax_tree(v)
            for k, v in params.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("case", list(CASES))
def test_spec_matches_reference(arch, case):
    """Speculative greedy tokens equal the non-speculative engine's, and the
    speculative engine's pool and prefix index drain.  Over an int8 pool the
    reference is the JAX speculative engine on the same weights (tokens and
    every tick's ``spec`` record): the verify pass attends its window's own
    K/V in full precision where a decode step reads them back quantized, so
    on some weights the JAX speculative engine's tokens leave its
    non-speculative engine's too (ROADMAP.md queue 3)."""
    cfg, params, dparams = port_setup(arch)
    draft, k, n_new, kw, which, n_samples = CASES[case]
    kw = dict(PAGED, **kw)
    if k == "fuzz":
        prompts, n_new, k, fkw = fuzz_case(n_new, cfg.vocab_size)
        kw.update(fkw)
    else:
        prompts = case_prompts(which)
    if kw.get("eos_id") == "probe":
        probe = serve(ContinuousEngine(cfg, params, device="cpu", **PAGED), Request, prompts, n_new)
        kw["eos_id"] = probe[0][4]  # the 5th token: EOS lands mid-window at k = 3
    dp = params if draft == "self" else dparams
    eng = ContinuousEngine(cfg, params, device="cpu", spec_k=k, spec_draft=(cfg, dp), **kw)
    spec = serve(eng, Request, prompts, n_new, n_samples)
    if case == "int8_pool":
        jcfg = jax_make_reduced(jax_get_config(ARCHS[arch][0])).replace(moe_impl=cfg.moe_impl)
        base_eng = JaxEngine(jcfg, jax_tree(params), spec_k=k, spec_draft=(jcfg, jax_tree(dp)),
                             **kw)
        base = serve(base_eng, JaxRequest, prompts, n_new, n_samples)
        assert spec_records(eng) == spec_records(base_eng)
    else:
        base_eng = ContinuousEngine(cfg, params, device="cpu", **kw)
        base = serve(base_eng, Request, prompts, n_new, n_samples)
    assert spec == base
    assert_drained(eng)
    assert eng.preemptions == base_eng.preemptions or case.startswith(("starved", "fuzz"))
    sp = spec_records(eng)
    drafted, accepted = sum(s["drafted"] for s in sp), sum(s["accepted"] for s in sp)
    if not eng.preemptions and "eos_id" not in kw:
        # every token but each request's first (its prefill's) is a spec emission
        assert sum(s["emitted"] for s in sp) + len(spec) == sum(len(t) for t in spec)
    counters = eng.obs.metrics.snapshot()["counters"]
    assert counters["spec.draft_tokens"] == drafted and counters["spec.accepted_tokens"] == accepted
    if draft == "self" and not case.startswith("eos"):
        assert drafted > 0 and accepted == drafted, "a self drafter accepts every window"
    if case == "low_accept":
        assert accepted < drafted, "a seed-1 drafter should reject some drafts"
    if case == "submit_n_forks":
        assert eng.cow_copies > 0, "3 samples decoding off one set of prompt pages must fork"
    if case == "k1":
        assert all(s["drafted"] <= s["windows"] for s in sp)
    if case.startswith("budget"):
        assert all(len(t) == n_new for t in spec)
    if case == "starved_pool":
        assert eng.preemptions > 0, "the pool was meant to starve"
    if case.startswith("fuzz"):
        assert sum(s["windows"] for s in sp) >= 10


def test_spec_tick_never_decodes_one_token(monkeypatch):
    """Every decoding slot goes through the verify pass: the one-token paged
    decode step (kernel 7) never runs, and each tick calls verify once."""
    from repro_torch.serving import continuous as tcont

    cfg, params, dparams = port_setup("glm4")
    calls = {"decode": 0, "verify": 0}
    verify = tcont.paged_verify_chunk_batched

    def count_verify(*a, **k):
        calls["verify"] += 1
        return verify(*a, **k)

    def no_decode(*a, **k):
        calls["decode"] += 1
        raise AssertionError("a speculative engine ran the one-token decode step")

    monkeypatch.setattr(tcont, "paged_verify_chunk_batched", count_verify)
    monkeypatch.setattr(tcont, "paged_ragged_decode_step", no_decode)
    eng = ContinuousEngine(cfg, params, device="cpu", spec_draft=(cfg, dparams), spec_k=3, **PAGED)
    serve(eng, Request, prompts_of(), 8)
    ticks = [m for m in eng.metrics_log if m["tokens_this_tick"]]
    assert calls == {"decode": 0, "verify": len(ticks)}
    assert all({"plan_s", "draft_s", "verify_s", "commit_s"} <= set(m) for m in ticks)


# ---------------------------------------------------------------------------
# Against the JAX speculative engine
# ---------------------------------------------------------------------------

# name -> (target, target moe_impl, drafter, drafter seed, JAX paged backend)
JAX_CASES = {
    # the paper's pairing: the dense student drafts for the MoE teacher, under
    # the teacher's own capacity dispatch ("dense"), where padded verify rows
    # compete for capacity: JAX on its kernel path, whose padded queries see
    # attention 0 as the port's do
    "nlg_pairing": ("nlg-350m-moe128", None, "nlg-350m", 1, "kernel"),
    "glm4_low_accept": ("glm4-9b", None, "glm4-9b", 1, None),
    "llama4_own_capacity_self": ("llama4-maverick-400b-a17b", None, "llama4-maverick-400b-a17b", 0,
                                 "kernel"),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_spec_matches_jax_spec_engine(case):
    """Tokens, every tick's ``spec`` record, preemptions and CoW copies equal
    the JAX speculative engine's on the same weights and drafter; a pool of
    14 pages for 3 slots of 32 (with a shared preamble) preempts."""
    name, moe_impl, dname, dseed, backend = JAX_CASES[case]
    jcfg, tcfg, jparams, tparams = jax_pair(name, 0, moe_impl)
    jdcfg, tdcfg, jdparams, tdparams = jax_pair(dname, dseed)
    prompts = [PRE + [11, 12], PRE + [13, 14, 15]] + prompts_of(n=3, seed=5, vocab=tcfg.vocab_size)
    kw = dict(slots=3, capacity=32, paged=True, page_size=4, n_pages=14, prefix_sharing=True,
              spec_k=3)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", spec_draft=(tdcfg, tdparams), **kw)
    tt = serve(teng, Request, prompts, 9)
    jattn.set_paged_backend(backend)
    try:
        jeng = JaxEngine(jcfg, jparams, spec_draft=(jdcfg, jdparams), **kw)
        jt = serve(jeng, JaxRequest, prompts, 9)
    finally:
        jattn.set_paged_backend(None)
    assert tt == jt
    assert spec_records(teng) == spec_records(jeng)
    assert (teng.preemptions, teng.cow_copies) == (jeng.preemptions, jeng.cow_copies)
    assert_drained(teng)


# ---------------------------------------------------------------------------
# Per-slot state: window rings, RG-LRU and SSD in the target or the drafter
# ---------------------------------------------------------------------------

# name -> (target, drafter ("self", "seed1" or another arch's seed-1 tree),
# engine options, prompts)
MIXED_CASES = {
    "gemma3_self_oracle": ("gemma3", "self", {}, None),
    "gemma3_low_accept": ("gemma3", "seed1", {}, None),
    "gemma3_prefix_sharing": ("gemma3", "seed1", dict(prefix_sharing=True), "preamble"),
    "recurrentgemma_self_oracle": ("recurrentgemma", "self", {}, None),
    "recurrentgemma_low_accept": ("recurrentgemma", "seed1", {}, None),
    "mamba2_low_accept_starved": ("mamba2", "seed1", dict(capacity=32, n_pages=10), "five"),
    # JAX's cross-family case: gemma3 (window rings) drafting for glm4
    "glm4_target_gemma3_drafter": ("glm4", "gemma3", {}, None),
    "recurrentgemma_target_mamba2_drafter": ("recurrentgemma", "mamba2", {}, None),
}


@pytest.mark.parametrize("case", list(MIXED_CASES))
def test_spec_with_per_slot_state_matches_reference(case):
    """Speculative greedy tokens equal the non-speculative engine's with a
    target or a drafter that keeps per-slot state; the verify pass leaves
    those leaves alone and the commit pass advances them over the accepted
    tokens; a drafter with per-slot state resyncs after every partial
    accept (counted per tick and in ``spec_resyncs``); pools drain."""
    target, draft, kw, which = MIXED_CASES[case]
    cfg, params, dparams = port_setup(target)
    dcfg, dp = (cfg, params) if draft == "self" else (
        (cfg, dparams) if draft == "seed1" else port_setup(draft)[::2])
    kw = dict(PAGED, **kw)
    prompts = case_prompts(which)
    eng = ContinuousEngine(cfg, params, device="cpu", spec_k=3, spec_draft=(dcfg, dp), **kw)
    spec = serve(eng, Request, prompts, 10)
    base = serve(ContinuousEngine(cfg, params, device="cpu", **kw), Request, prompts, 10)
    assert spec == base
    assert_drained(eng)
    sp = spec_records(eng)
    drafted, accepted = sum(s["drafted"] for s in sp), sum(s["accepted"] for s in sp)
    resyncs = sum(s.get("resyncs", 0) for s in sp)
    assert eng.spec_resyncs == resyncs
    if draft == "self":
        assert drafted > 0 and accepted == drafted and resyncs == 0
    else:
        assert accepted < drafted, "a seed-1 drafter should reject some drafts"
    partial = sum(s["accepted"] < s["drafted"] for s in sp)  # ticks with a partial accept
    if draft != "self" and not eng.drafter.exact_partial:
        assert resyncs >= partial > 0, "a drafter with per-slot state resyncs after partial accepts"
    if case.endswith("starved"):
        assert eng.preemptions > 0


@pytest.mark.parametrize("case", ["gemma3_int8_pool", "recurrentgemma_low_accept"])
def test_spec_with_per_slot_state_matches_jax_spec_engine(case):
    """Against the JAX speculative engine on the same weights: gemma3 (rings
    beside the pool) over an int8 pool, and recurrentgemma (no pool: RG-LRU
    and rings) with a low-accept drafter, whose resyncs JAX counts too.
    Tokens and every tick's ``spec`` record equal."""
    name = "gemma3-27b" if case.startswith("gemma3") else "recurrentgemma-2b"
    jcfg, tcfg, jparams, tparams = jax_pair(name, 0)
    _, _, jdparams, tdparams = jax_pair(name, 1)
    kw = dict(PAGED, spec_k=3, kv_cache_bits=8 if "int8" in case else 0)
    # one prompt length and few new tokens: the JAX engine compiles its
    # prefill, and a resynced drafter's, anew for each length
    prompts = prompts_of(lo=8, hi=9)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", spec_draft=(tcfg, tdparams), **kw)
    tt = serve(teng, Request, prompts, 5)
    jeng = JaxEngine(jcfg, jparams, spec_draft=(jcfg, jdparams), **kw)
    jt = serve(jeng, JaxRequest, prompts, 5)
    assert tt == jt
    assert spec_records(teng) == spec_records(jeng)
    assert_drained(teng)
    if case.startswith("recurrentgemma"):
        assert teng.spec_resyncs > 0


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_commit_pass_leaves_the_pool_untouched(kv_bits, monkeypatch):
    """gemma3 with a low-accept drafter: before each call of the committed
    recurrent-state pass the pool entries of the positions it re-runs (the
    verify pass stored them; the pass masks them as keys) are set to a
    sentinel; after it they still hold the sentinel, every other pool page
    is byte-identical (its writes all go to the trash page, the ``already``
    guard, whose positions stay -1), and the per-slot leaves have moved (the
    rings advance).  The stored values are put back before the run goes on."""
    cfg, params, dparams = port_setup("gemma3")
    seen = {"calls": 0, "pool_same": True, "leaves_moved": 0}
    commit = ContinuousEngine._spec_commit

    def pages(caches):  # [repeats, pages, page_size, ...]: K / V (q, scale) and pos
        return [x for sk, pk, _, paged in tm._layer_entries(cfg) if paged
                for x in tm._tensors(caches[sk][pk]["self"])]

    def checked(self, rows, S, C):
        ps = self.page_size
        at = [(int(self.tables.row(i)[q // ps]), q % ps) for i, pl, app in rows
              for q in range(pl["p"], pl["p"] + len(app))]
        idx = (slice(None), torch.tensor([a for a, _ in at]), torch.tensor([b for _, b in at]))
        kv = [x for x in pages(self.caches) if x.dtype != torch.int32]
        stored = [x[idx].clone() for x in kv]
        for x in kv:
            x[idx] = 99 if x.dtype == torch.int8 else 1234.5
        before = [x[:, :-1].clone() for x in pages(self.caches)]
        leaves = [x.clone() for _, leaf in tm._slot_leaves(cfg, self.caches, True)
                  for x in tm._tensors(leaf)]
        commit(self, rows, S, C)
        seen["calls"] += 1
        seen["pool_same"] &= all(torch.equal(a, b[:, :-1]) for a, b in zip(before,
                                                                           pages(self.caches)))
        seen["pool_same"] &= bool((tm._pool_layer(cfg, self.caches)["pos"][:, -1] == -1).all())
        seen["leaves_moved"] += not all(torch.equal(a, b) for a, b in zip(
            leaves, (x for _, leaf in tm._slot_leaves(cfg, self.caches, True)
                     for x in tm._tensors(leaf))))
        for x, v in zip(kv, stored):
            x[idx] = v

    monkeypatch.setattr(ContinuousEngine, "_spec_commit", checked)
    eng = ContinuousEngine(cfg, params, device="cpu", spec_draft=(cfg, dparams), spec_k=3,
                           kv_cache_bits=kv_bits, **PAGED)
    toks = serve(eng, Request, prompts_of(), 8)
    ticks = sum("spec" in m for m in eng.metrics_log)
    assert seen == {"calls": ticks, "pool_same": True, "leaves_moved": ticks} and ticks > 0
    assert toks == serve(ContinuousEngine(cfg, params, device="cpu", kv_cache_bits=kv_bits,
                                          **PAGED), Request, prompts_of(), 8)


# ---------------------------------------------------------------------------
# The model entries
# ---------------------------------------------------------------------------


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_verify_chunk_batched_matches_jax(kv_bits):
    """A batched prefill writes two rows' histories (11 and 6 tokens), then
    one verify call scores windows of 4 and 2 positions (row 1 padded, row 2
    inactive) through tables whose window entries point at fresh pages and
    a fork of row 0's boundary page: logits at every valid window position
    and the pools equal JAX's."""
    jcfg, tcfg, jparams, tparams = jax_pair("glm4-9b")
    S, C, MP, n_pages, ps = 3, 4, 8, 16, 4
    kw = dict(capacity=32, kv_bits=kv_bits, page_size=ps)
    jc = jm.init_paged_caches(jcfg, S, 32, n_pages=n_pages, page_size=ps, kv_bits=kv_bits)
    tc = tm.init_paged_caches(tcfg, S, 32, n_pages=n_pages, page_size=ps, kv_bits=kv_bits,
                              device="cpu")
    rng = np.random.default_rng(4)
    hist = {0: rng.integers(1, 500, 11), 1: rng.integers(1, 500, 6)}
    tables = np.full((S, MP), -1, np.int32)
    tables[0, :3], tables[1, :2] = [5, 1, 9], [0, 7]
    toks, pos = np.zeros((S, 12), np.int32), np.full((S, 12), -1, np.int32)
    active, last = np.zeros(S, bool), np.zeros(S, np.int32)
    for i, h in hist.items():
        toks[i, : len(h)], pos[i, : len(h)] = h, np.arange(len(h))
        active[i], last[i] = True, len(h) - 1
    jl, jc = jm.paged_prefill_chunk_batched(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(active),
        jnp.asarray(active), jnp.asarray(last), jc, jnp.asarray(tables), **kw)
    tl, tc = tm.paged_prefill_chunk_batched(tcfg, tparams, t(toks).long(), t(pos), t(active),
                                            t(active), t(last), tc, t(tables))
    # the window: row 0 at 11 (mid-page: the boundary page 9 forked to 12,
    # position 14 lands on fresh page 3), row 1 at 6 (private boundary 7)
    jc = jm.paged_copy_page(jcfg, jc, jnp.asarray(9), jnp.asarray(12))
    tc = tm.paged_copy_page(tcfg, tc, 9, 12)
    vt = np.full((S, MP), -1, np.int32)
    vt[0, :4], vt[1, :2] = [5, 1, 12, 3], [0, 7]
    vtoks, vpos = np.zeros((S, C), np.int32), np.full((S, C), -1, np.int32)
    vtoks[0], vpos[0] = rng.integers(1, 500, 4), np.arange(11, 15)
    vtoks[1, :2], vpos[1, :2] = rng.integers(1, 500, 2), [6, 7]
    vactive = np.array([True, True, False])
    jl, jc = jm.paged_verify_chunk_batched(jcfg, jparams, jnp.asarray(vtoks), jnp.asarray(vpos),
                                           jnp.asarray(vactive), jc, jnp.asarray(vt), **kw)
    tl, tc = tm.paged_verify_chunk_batched(tcfg, tparams, t(vtoks).long(), t(vpos), t(vactive),
                                           tc, t(vt))
    assert tuple(tl.shape) == (S, C, tcfg.vocab_size)
    valid = vpos >= 0
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **TOL)
    assert_pools_close(tcfg, tc, jc)


def test_reset_page_tails_matches_jax():
    """Random pool positions; rows that hit one page twice (a page two
    slots' tails share), a page past offset 0, an ``offs = page_size`` row
    (no-op), a -1 row and a row naming the trash page: every layer's
    positions equal JAX's, exactly, and k / v are untouched."""
    jcfg, tcfg, _, _ = jax_pair("llama4-maverick-400b-a17b")
    n_pages, ps = 10, 4
    jc = jm.init_paged_caches(jcfg, 6, 32, n_pages=n_pages, page_size=ps)
    tc = tm.init_paged_caches(tcfg, 6, 32, n_pages=n_pages, page_size=ps, device="cpu")
    rng = np.random.default_rng(9)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.integers(-1, 40, a.shape).astype(a.dtype))
                      if a.dtype == jnp.int32 else a, jc)
    copy_into(tc, jc)
    before = [x.clone() for x, _ in leaves_like(tc, jc) if x.dtype != torch.int32]
    pages = np.array([3, 3, 7, -1, 5, n_pages], np.int32)
    offs = np.array([2, 1, 0, 0, ps, 3], np.int32)
    jc = jm.paged_reset_page_tails(jcfg, jc, jnp.asarray(pages), jnp.asarray(offs))
    tc = tm.paged_reset_page_tails(tcfg, tc, t(pages), t(offs))
    for x, y in leaves_like(tc, jc):
        if x.dtype == torch.int32:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    after = [x for x, _ in leaves_like(tc, jc) if x.dtype != torch.int32]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def live_pages_below_length(eng):
    """No page a decoding slot maps holds a position >= the slot's length."""
    pos = tm._pool_layer(eng.cfg, eng.caches)["pos"]  # [repeats, n_pages + 1, ps]
    for i, s in enumerate(eng.slots):
        if s.active and not s.prefilling:
            row = [int(p) for p in eng.tables.row(i) if p >= 0]
            if row and int(pos[:, row].max()) >= s.pos:
                return False
    return True


def test_partial_accepts_leave_no_position_past_the_length(monkeypatch):
    """After every tick of a low-accept run over 4-token pages with k = 6
    (windows over two or three pages, most rejected), no live page holds a
    position >= its slot's length; without the tail reset the same run
    breaks that invariant."""
    from repro_torch.serving import continuous as tcont

    cfg, params, dparams = port_setup("glm4")

    def run():
        eng = ContinuousEngine(cfg, params, device="cpu", spec_draft=(cfg, dparams), spec_k=6,
                               **PAGED)
        for p in prompts_of():
            eng.submit(Request(prompt=p, max_new_tokens=14))
        held, partial = True, 0
        while eng.step() or eng.queue:
            held &= live_pages_below_length(eng)
            partial += sum(s["accepted"] < s["drafted"] for s in spec_records(eng)[-1:])
        return held, partial

    held, partial = run()
    assert held and partial > 0
    monkeypatch.setattr(tcont, "paged_reset_page_tails", lambda cfg, caches, *a: caches)
    assert run()[0] is False


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["self", "glm4-9b"])
def test_cli_spec_draft(capsys, draft):
    tserve.main(["--arch", "glm4-9b", "--reduced", "--paged", "--spec-draft", draft,
                 "--spec-k", "3", "--device", "cpu", "--page-size", "4", "--requests", "3",
                 "--prompt-len", "6", "--new-tokens", "5"])
    out = capsys.readouterr().out
    # each request's first token is its prefill's, the other 4 speculative
    assert "speculation: 12 tokens / " in out and "k=3)" in out
    assert "served 3 requests, 15 tokens" in out


@pytest.mark.parametrize("flags,err", [
    (["--spec-draft", "self"], "pass --paged"),
    (["--paged", "--spec-draft", "self", "--temperature", "0.5"], "greedy-only"),
    (["--paged", "--spec-draft", "llama4-maverick-400b-a17b"], "drafter vocab"),
    (["--paged", "--spec-draft", "self", "--spec-k", "0"], "--spec-k must be >= 1"),
], ids=["unpaged", "sampling", "vocab", "k0"])
def test_cli_spec_refusals(capsys, flags, err):
    arch = "glm4-9b" if "vocab" not in err else "nlg-350m"
    red = [] if "vocab" in err else ["--reduced"]
    with pytest.raises(SystemExit):
        tserve.main(["--arch", arch, *red, "--device", "cpu", *flags])
    assert err in capsys.readouterr().err
