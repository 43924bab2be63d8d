"""Port parity for prefix sharing with copy-on-write and ``submit_n`` forks:
the port's copy of the prefix index, ``paged_copy_page`` /
``paged_copy_slot_leaves``, and the paged ``ContinuousEngine`` with
``prefix_sharing=True`` against the JAX engine (the cases of
``tests/test_prefix.py``), on reduced glm4-9b (a dense global arch: every
layer paged) in f32 on the CPU, from the same numpy weights.

Tolerances: page copies are exact (bit-identical pools); engines must give
identical greedy tokens per request id, preemption counts, prefix hits and
hit tokens, CoW copies, prefill tokens computed and skipped, shared and free
page counts at every tick, and a drained pool and index.
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.models import model as jm
from repro.serving import prefix_index as jprefix
from repro.serving.continuous import ContinuousEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs.registry import get_config, make_reduced
from repro_torch.models import model as tm
from repro_torch.serving import prefix_index as tprefix
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Request
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

PRE = [7, 7, 3, 5, 1, 2, 9, 4]  # 2 full pages at page_size=4: the shared preamble
SHARED = dict(capacity=32, paged=True, page_size=4, n_pages=24, prefix_sharing=True)
INDEXES = pytest.mark.parametrize("mod", [jprefix, tprefix], ids=["jax", "torch"])


@functools.lru_cache(maxsize=None)
def load(name, moe_impl=None):
    """(JAX cfg, port cfg, JAX params, port params) of a reduced arch, the
    port's converted from the JAX tree."""
    jcfg = jax_make_reduced(jax_get_config(name))
    tcfg = make_reduced(get_config(name))
    if moe_impl:
        jcfg, tcfg = jcfg.replace(moe_impl=moe_impl), tcfg.replace(moe_impl=moe_impl)
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def glm4():
    return load("glm4-9b")


def record(eng, ids):
    """What the two engines must agree on after a run."""
    done = eng.done
    rec = {"tokens": [done[i].tokens for i in ids], "preemptions": eng.preemptions,
           "prefill_tokens": eng.prefill_tokens_total}
    if eng.paged:
        rec.update(cow_copies=eng.cow_copies, free=eng.pool.free_count,
                   shared_per_tick=[m["shared_pages"] for m in eng.metrics_log],
                   free_per_tick=[m["free_pages"] for m in eng.metrics_log])
        eng.pool.check()
    if eng.prefix is not None:
        rec.update(prefix_hits=eng.prefix_hits, prefix_hit_tokens=eng.prefix_hit_tokens,
                   skipped=eng.prefill_tokens_skipped, index=len(eng.prefix))
    return rec


def both(pair, script, **kw):
    """``script(engine, Request)`` on a JAX and a port engine built with the
    same options; returns (JAX result, port result, port engine)."""
    jcfg, tcfg, jparams, tparams = pair
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    return script(jeng, JaxRequest), script(teng, Request), teng


def serve(prompts, n_new):
    def script(eng, req):
        ids = [eng.submit(req(prompt=p, max_new_tokens=n_new)) for p in prompts]
        eng.run_until_done()
        return record(eng, ids)
    return script


def first_pool(cfg, caches):
    return next(caches[sk][pk]["self"] for sk, pk, _, paged in tm._layer_entries(cfg) if paged)


# ---------------------------------------------------------------------------
# The prefix index (the cases of test_prefix.py, on both copies)
# ---------------------------------------------------------------------------


def test_index_is_a_verbatim_copy():
    """Everything after the module docstring is the JAX package's code."""
    body = lambda m: inspect.getsource(m).split('"""', 2)[2]
    assert body(tprefix) == body(jprefix)


@INDEXES
def test_index_insert_lookup_full_pages_only(mod):
    idx = mod.PrefixIndex(4)
    toks = list(range(10))
    assert idx.insert(toks, [5, 9]) == 2
    assert idx.lookup(toks) == [5, 9]
    assert idx.lookup(toks[:7]) == [5]
    assert idx.lookup(toks, max_tokens=7) == [5]
    assert idx.lookup([1] + toks[1:]) == []


@INDEXES
def test_index_first_writer_wins_and_eviction_holes(mod):
    idx = mod.PrefixIndex(4)
    toks = list(range(8))
    idx.insert(toks, [1, 2])
    assert idx.insert(toks, [3, 4]) == 0
    idx.evict_pages([1])  # a mid-chain hole stops the match
    assert idx.lookup(toks) == [] and len(idx) == 1
    idx.insert(toks, [9, 7])
    assert idx.lookup(toks) == [9, 2]
    idx.evict_pages([9, 2])
    assert len(idx) == 0


@INDEXES
def test_index_duplicate_page_at_new_path_raises(mod):
    idx = mod.PrefixIndex(2)
    idx.insert([1, 2], [0])
    with pytest.raises(ValueError, match="already indexed"):
        idx.insert([3, 4], [0])


# ---------------------------------------------------------------------------
# Device copies
# ---------------------------------------------------------------------------


def random_pool(pair, kv_bits, seed=0):
    """The same random paged caches on both sides (6 pages of 4)."""
    jcfg, tcfg, _, _ = pair
    jc = jm.init_paged_caches(jcfg, 2, 16, n_pages=6, page_size=4, kv_bits=kv_bits)
    rng = np.random.default_rng(seed)
    leaves, tdef = jax.tree.flatten(jc)
    vals = [rng.integers(-100, 100, x.shape).astype(x.dtype) if x.dtype != jnp.float32
            else rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    jc = jax.tree.unflatten(tdef, [jnp.asarray(v) for v in vals])
    tc = tm.init_paged_caches(tcfg, 2, 16, n_pages=6, page_size=4, kv_bits=kv_bits, device="cpu")
    copy_into(tc, jc)
    return jc, tc


def copy_into(tree, jtree):
    """Copy a JAX cache tree's values into the port's tree of the same keys."""
    for key, leaf in tree.items():
        if torch.is_tensor(leaf):
            leaf.copy_(torch.from_numpy(np.asarray(jtree[key])))
        elif isinstance(leaf, dict):
            copy_into(leaf, jtree[key])
        else:  # QuantizedKV
            leaf.q.copy_(torch.from_numpy(np.asarray(jtree[key].q)))
            leaf.scale.copy_(torch.from_numpy(np.asarray(jtree[key].scale)))


def leaves_like(tree, jtree):
    """(port tensor, JAX array) pairs by key."""
    for key, leaf in tree.items():
        if torch.is_tensor(leaf):
            yield leaf, jtree[key]
        elif isinstance(leaf, dict):
            yield from leaves_like(leaf, jtree[key])
        else:
            yield leaf.q, jtree[key].q
            yield leaf.scale, jtree[key].scale


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_paged_copy_page_matches_jax(glm4, kv_bits):
    """k, v and pos (an int8 pool's q and scale) of page 4 become page 1's,
    in place, exactly as JAX's functional copy; every other page stays."""
    jc, tc = random_pool(glm4, kv_bits)
    before = [t.clone() for t in tm._tensors(tc)]
    out = jm.paged_copy_page(glm4[0], jc, 1, 4)
    tm.paged_copy_page(glm4[1], tc, 1, 4)
    for t, j in leaves_like(tc, out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, b in zip(tm._tensors(tc), before):
        assert torch.equal(t[:, 4], t[:, 1]) and torch.equal(t[:, :4], b[:, :4])


def test_paged_copy_slot_leaves_copies_rows_and_leaves_the_pool(glm4):
    """The port's paged caches hold pool leaves only: the pool is untouched.
    A per-slot leaf added beside the pool (what ROADMAP item 5 adds) has
    its row copied."""
    _, tc = random_pool(glm4, 0)
    before = [t.clone() for t in tm._tensors(tc)]
    ring = torch.arange(3 * 5, dtype=torch.float32).view(1, 3, 5)  # [repeats, slots, ...]
    tc["seg0"]["pos0"]["ring"] = {"pos": ring}
    tm.paged_copy_slot_leaves(glm4[1], tc, 0, 2)
    assert torch.equal(ring[:, 2], ring[:, 0]) and torch.equal(ring[0, 1], torch.arange(5, 10.0))
    del tc["seg0"]["pos0"]["ring"]
    assert all(torch.equal(a, b) for a, b in zip(tm._tensors(tc), before))


# ---------------------------------------------------------------------------
# Physical sharing and CoW isolation (TestPhysicalSharing)
# ---------------------------------------------------------------------------


def test_two_slots_share_common_prefix_pages(glm4):
    """Two admissions with a two-page common prefix hold the same pages
    (refcount 2; 4 pages in use, not 6), and serve as the JAX engine."""
    def script(eng, req):
        ids = [eng.submit(req(prompt=PRE + [11], max_new_tokens=4)),
               eng.submit(req(prompt=PRE + [12, 13], max_new_tokens=4))]
        shared = [int(p) for p in eng.tables.row(0)[:2]]
        state = ([int(p) for p in eng.tables.row(1)[:2]] == shared,
                 [eng.pool.refcount(p) for p in shared], eng.pool.used_count)
        eng.run_until_done()
        return state, record(eng, ids)

    (js, jr), (ts, tr), _ = both(glm4, script, slots=2, **SHARED)
    assert ts == js == (True, [2, 2], 4)
    assert tr == jr and tr["prefix_hits"] == 1 and tr["prefix_hit_tokens"] == len(PRE)
    assert tr["free"] == SHARED["n_pages"] and tr["index"] == 0


def test_cow_never_mutates_page_visible_to_another_slot(glm4):
    """Two forks of a 10-token prompt share its partial boundary page; the
    first decode tick copies it, and the prompt's entries of every copy stay
    bit-identical to the original's."""
    _, tcfg, _, tparams = glm4
    eng = ContinuousEngine(tcfg, tparams, device="cpu", slots=2, **SHARED)
    rids = eng.submit_n(Request(prompt=PRE + [11, 12], max_new_tokens=5), 2)
    boundary = int(eng.tables.row(0)[2])
    assert int(eng.tables.row(1)[2]) == boundary and eng.pool.refcount(boundary) == 2
    pool = first_pool(tcfg, eng.caches)
    k0, p0 = pool["k"][:, boundary, :2].clone(), pool["pos"][:, boundary, :2].clone()
    eng.step()
    assert eng.cow_copies == 1
    pages = {int(eng.tables.row(0)[2]), int(eng.tables.row(1)[2])}
    assert len(pages) == 2
    for b in pages:
        assert torch.equal(pool["k"][:, b, :2], k0) and torch.equal(pool["pos"][:, b, :2], p0)
    done = eng.run_until_done()
    assert sorted(done) == rids and eng.pool.free_count == eng.n_pages
    eng.pool.check()


def test_preempted_sharer_decrefs_not_frees(glm4):
    """Preempting a slot that shares prefix pages leaves them live (and
    indexed) for the other; both requests end as without sharing."""
    prompts = [PRE + [21], PRE + [22]]

    def script(eng, req):
        ids = [eng.submit(req(prompt=p, max_new_tokens=6)) for p in prompts]
        shared = [int(p) for p in eng.tables.row(0)[:2]]
        eng._preempt(1)
        state = ([eng.pool.refcount(p) for p in shared], len(eng.prefix) > 0)
        eng.run_until_done()
        return state, record(eng, ids)

    (js, jr), (ts, tr), _ = both(glm4, script, slots=2, **SHARED)
    assert ts == js == ([1, 1], True)
    assert tr == jr and tr["preemptions"] == 1 and tr["index"] == 0
    _, tcfg, _, tparams = glm4
    plain = serve(prompts, 6)(ContinuousEngine(tcfg, tparams, device="cpu", slots=2,
                                               **dict(SHARED, prefix_sharing=False)), Request)
    assert tr["tokens"] == plain["tokens"]


# ---------------------------------------------------------------------------
# Greedy parity with sharing (TestPrefixParity)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefill_mode", ["chunked", "batched", "scatter"])
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_sharing_matches_jax_and_the_unshared_engine(glm4, kv_bits, prefill_mode):
    """Five requests over 3 slots, four opening with the shared preamble
    (the queued ones admit after its pages are indexed): the port's engine
    equals the JAX engine in everything ``record`` holds, and its tokens
    equal its own unshared engine's."""
    prompts = [PRE + [11], PRE + [12, 13], [9, 8, 7], PRE + [14, 15, 16], PRE + [17, 18, 19, 20, 21]]
    kw = dict(SHARED, slots=3, kv_cache_bits=kv_bits, prefill_mode=prefill_mode, prefill_chunk=8)
    jr, tr, _ = both(glm4, serve(prompts, 5), **kw)
    assert tr == jr
    assert tr["prefix_hits"] >= 1 and tr["free"] == SHARED["n_pages"] and tr["index"] == 0
    _, tcfg, _, tparams = glm4
    plain = serve(prompts, 5)(ContinuousEngine(tcfg, tparams, device="cpu",
                                               **dict(kw, prefix_sharing=False)), Request)
    assert tr["tokens"] == plain["tokens"]


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_n_samples_fork_matches_jax(glm4, kv_bits):
    """Three greedy samples of one 10-token prompt: all three tables alias
    its pages (refcount 3), two of the three holders copy the boundary page
    away, and tokens and counts equal the JAX engine's and, token for token,
    three independent submissions."""
    req = dict(prompt=PRE + [31, 32], max_new_tokens=6)

    def script(eng, r):
        rids = eng.submit_n(r(**req), 3)
        rows = [[int(p) for p in eng.tables.row(i)[:3]] for i in range(3)]
        state = (rows[0] == rows[1] == rows[2], [eng.pool.refcount(p) for p in rows[0]])
        eng.run_until_done()
        return state, record(eng, rids)

    kw = dict(SHARED, slots=3, kv_cache_bits=kv_bits)
    (js, jr), (ts, tr), _ = both(glm4, script, **kw)
    assert ts == js == (True, [3, 3, 3])
    assert tr == jr and tr["cow_copies"] >= 2 and tr["free"] == SHARED["n_pages"]
    _, tcfg, _, tparams = glm4
    alone = ContinuousEngine(tcfg, tparams, device="cpu", **dict(kw, prefix_sharing=False))
    ids = alone.submit_n(Request(**req), 3)
    done = alone.run_until_done()
    assert [done[i].tokens for i in ids] == tr["tokens"]


def test_fork_waits_for_a_midprefill_base(glm4):
    """A chunked base of 18 tokens needs three 8-token ticks: its forks wait
    at the queue head (not admitted as plain requests) and then share all
    its pages; the JAX engine does the same."""
    def script(eng, r):
        rids = eng.submit_n(r(prompt=PRE + list(range(20, 30)), max_new_tokens=4), 2)
        waiting = [len(eng.queue)]
        while eng.slots[0].prefilling:
            eng.step()
            waiting.append(len(eng.queue))
        eng.run_until_done()
        return waiting, record(eng, rids)

    (jw, jr), (tw, tr), _ = both(glm4, script, slots=2, prefill_chunk=8, **SHARED)
    assert tw == jw and tw[0] == 1 and tw[-1] == 0
    assert tr == jr and tr["prefix_hits"] == 1
