"""Slot-sharded expert-parallel serving of the port (``cfg.ep_mesh``): the
attention, the caches and the non-expert layers data-parallel over the
slots, as the JAX package's ``place_caches`` and ``batch`` hints lay them
out, on meshes (4,) and (2, 2).

One module fixture spawns 4 gloo ranks (``serving.ep.launch``) that serve
every case on both meshes, while the JAX engines serve the first five cases
on one device in this process (JAX's ``TestShardedEngineParity`` cases,
``tests/test_dist_serving.py``) and the port's one-device engines serve
them all.  For those five (reduced glm4, paged; reduced gemma3 with int8 KV
pages and rings; reduced nlg with 8 experts at capacity factor 8.0 under
``grouped`` with the batched prefill and prefix sharing; the static
``Engine`` and the contiguous ``ContinuousEngine`` on that nlg), 8 slots
(2 a rank on both meshes):

  * greedy tokens equal JAX's one-device engine, on every rank;
  * each rank's per-slot cache leaves equal the one-device port's rows of
    its slots, exactly;
  * every rank's page pool is the same bytes as rank 0's (and as one
    device's).

Also: the rows rule against JAX's ``_filter_axes`` and ``cache_pspecs``
(2 slots on (2, 2) shard over the outer axis only, 3 on (4,) replicate,
``n_pages + 1 == slots`` replicates); 2 slots on (2, 2) served through the
a2a prefill over partial axes (hazard: the rows are gathered, then split);
a ``submit_n`` fork whose base and samples sit on different ranks (gemma3's
rings go by broadcast); recurrentgemma's chunked prefill under a mesh (its
single-slot chunks run on every rank, the slot's state sent by its holder);
sampling at temperature 0.8 (the logits gathered, each rank drawing what
one device draws).

One row a rank (4 slots on 4 ranks) keeps tokens and the ranks' pools
equal, but not every bit of the caches: a one-row matrix product takes
another BLAS path (a matrix-vector product) than the one-device engine's
four-row product, whose sums differ in the last bits.  That case (gemma3's
fp rings) holds the per-slot leaves to 1e-5 and their positions exactly.
"""
import concurrent.futures
import functools
import types

import jax
import numpy as np
import pytest

import _torch_ep_ranks as ranks
from repro.configs.registry import all_configs as jax_configs
from repro.configs.registry import make_reduced as jax_make_reduced
from repro.configs.registry import with_moe_ffn as jax_with_moe_ffn
from repro.models import model as jm
from repro.serving import continuous as jc
from repro.serving import engine as je
from repro_torch.configs.registry import get_config, make_reduced, with_moe_ffn
from repro_torch.launch.steps import paper_mesh
from repro_torch.models.model import init_paged_caches, slot_rows
from repro_torch.parallel.params import cache_pspecs
from repro_torch.parallel.sharding import RowShard, batch_shard, row_axes
from repro_torch.quant.kv import QuantizedKV
from repro_torch.serving import ep
from _torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

pytestmark = pytest.mark.dist

GLM4, GEMMA3, NLG, RG = "glm4-9b", "gemma3-27b", "nlg-350m-moe128", "recurrentgemma-2b"
PRE = [7, 7, 3, 5, 1, 2, 9, 4]
PROMPTS = [PRE + [3, 5, 1], PRE + [8, 2], [11, 2, 3, 7, 5, 6, 1, 9, 2, 3], [5],
           [4, 4, 9], PRE + [1], [2, 6, 2, 6, 2, 6, 2, 6, 2, 6, 2, 6], [6, 1]]
NEW = 8
PAGED = dict(slots=8, capacity=64, paged=True, page_size=8)
RULES = {"flat4": {"expert": "data", "batch": "data"},
         "hier22": {"expert": ("pod", "data"), "batch": ("pod", "data")}}
MESH = {"flat4": ((4,), ("data",)), "hier22": ((2, 2), ("pod", "data"))}


@functools.lru_cache(maxsize=None)
def configs(arch, variant=""):
    """(JAX cfg, port cfg, JAX params, the params as numpy)."""
    if arch == NLG:
        jcfg = jax_with_moe_ffn(jax_make_reduced(jax_configs()[NLG]), num_experts=8,
                                capacity_factor=8.0)
        tcfg = with_moe_ffn(make_reduced(get_config(NLG)), num_experts=8, capacity_factor=8.0)
        if variant == "grouped":
            jcfg, tcfg = jcfg.replace(moe_impl="grouped"), tcfg.replace(moe_impl="grouped")
    else:
        jcfg, tcfg = jax_make_reduced(jax_configs()[arch]), make_reduced(get_config(arch))
    jparams = jax.jit(lambda k: jm.init_params(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams)


# name -> (arch, variant, engine, kw): held against JAX's one-device engine
JAX_CASES = {
    "glm4": (GLM4, "", "continuous", PAGED),
    "gemma3_int8": (GEMMA3, "", "continuous", dict(PAGED, kv_cache_bits=8)),
    "nlg_grouped": (NLG, "grouped", "continuous",
                    dict(PAGED, prefix_sharing=True, prefill_mode="batched")),
    "static": (NLG, "", "static", dict(max_batch=8, max_prefill=32, max_decode=8)),
    "contiguous": (NLG, "", "continuous", dict(slots=8, capacity=64)),
    "contiguous_int8": (NLG, "", "continuous", dict(slots=8, capacity=64, kv_cache_bits=8)),
}
# held against the port's one-device engine
PORT_CASES = {
    "partial": (NLG, "", "continuous", dict(slots=2, capacity=64, paged=True, page_size=8,
                                             prefill_mode="batched"), PROMPTS[:4], {}),
    "fork": (GEMMA3, "", "continuous", dict(PAGED, prefix_sharing=True), PROMPTS[:5],
             dict(fork=4)),
    "recurrent": (RG, "", "continuous", dict(PAGED, prefill_chunk=8), PROMPTS, {}),
    "sampled": (NLG, "", "static", dict(max_batch=8, max_prefill=32, max_decode=8,
                                        temperature=0.8, top_k=5), PROMPTS, {}),
    "one_row": (GEMMA3, "", "continuous", dict(PAGED, slots=4), PROMPTS, {}),
}


def jax_tokens(arch, variant, engine, kw):
    jcfg, _, jparams, _ = configs(arch, variant)
    if engine == "static":
        out = je.Engine(jcfg, jparams, je.EngineConfig(**kw)).generate(
            [je.Request(p, NEW) for p in PROMPTS])
        return [r.tokens for r in out]
    eng = jc.ContinuousEngine(jcfg, jparams, **kw)
    ids = [eng.submit(je.Request(prompt=p, max_new_tokens=NEW)) for p in PROMPTS]
    done = eng.run_until_done()
    return [done[i].tokens for i in ids]


def port_case(arch, variant, engine, kw, prompts=PROMPTS, extra=None):
    _, tcfg, _, tree = configs(arch, variant)
    return dict(cfg=tcfg, params=tree, engine=engine, kw=kw, prompts=prompts, new=NEW,
                **(extra or {}))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cases = {name: port_case(*c) for name, c in JAX_CASES.items()}
    cases.update({name: port_case(*c) for name, c in PORT_CASES.items()})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(ep.launch, ranks.slot_engines, 4, backend="gloo", args=(cases,),
                          timeout_s=400, rendezvous_dir=tmp_path_factory.mktemp("ep"))
        jax_out = {name: jax_tokens(*c) for name, c in JAX_CASES.items()}
        one = {name: ranks.slot_case(case) for name, case in cases.items()}
        port = run.result()
    return dict(port=port, jax=jax_out, one=one)


def _rows(mesh, n):
    shape, names = MESH[mesh]
    return [batch_shard(n, paper_mesh(shape, names, rank=r), RULES[mesh]) for r in range(4)]


@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_tokens_equal_jax_one_device(served, case, mesh):
    want = served["jax"][case]
    assert all(len(t) == NEW for t in want)
    assert served["one"][case]["tokens"] == want
    for r in range(4):
        assert served["port"][r][f"{mesh}/{case}"]["tokens"] == want, r


@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_slot_leaves_are_the_one_device_rows(served, case, mesh):
    one = served["one"][case]
    names = MESH[mesh][1]
    for r in range(4):
        got = served["port"][r][f"{mesh}/{case}"]
        axes, lo, hi = got["rows"]
        assert (axes, lo, hi) == (names, 2 * r, 2 * r + 2)
        assert len(got["per"]) == len(one["per"])
        for a, b in zip(got["per"], one["per"]):
            assert a.shape[1] == 2 and np.array_equal(a, b[:, lo:hi])
    # attention-only glm4 and nlg keep nothing per slot when paged
    assert bool(one["per"]) == (case in ("gemma3_int8", "static", "contiguous",
                                         "contiguous_int8"))


@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("case", [c for c, (_, _, _, kw) in JAX_CASES.items() if kw.get("paged")])
def test_pools_are_the_same_bytes_on_every_rank(served, case, mesh):
    pool0 = served["port"][0][f"{mesh}/{case}"]["pool"]
    assert pool0 and all(np.array_equal(a, b) for a, b in zip(pool0, served["one"][case]["pool"]))
    for r in range(1, 4):
        pool = served["port"][r][f"{mesh}/{case}"]["pool"]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(pool, pool0)), r


@pytest.mark.parametrize("mesh", list(MESH))
@pytest.mark.parametrize("case", ["partial", "fork", "recurrent", "sampled", "one_row"])
def test_other_layouts_give_one_device_tokens(served, case, mesh):
    want = served["one"][case]["tokens"]
    assert all(len(t) == NEW for t in want)
    for r in range(4):
        got = served["port"][r][f"{mesh}/{case}"]
        assert got["tokens"] == want, r
        pool0 = served["port"][0][f"{mesh}/{case}"]["pool"]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got["pool"], pool0))
        rows = got["rows"]
        if case == "partial":
            # 2 slots: (2, 2) shards them over its outer axis, (4,) cannot
            assert rows == ((("pod",), r // 2, r // 2 + 1) if mesh == "hier22" else None)
        elif case == "one_row":
            assert rows == (MESH[mesh][1], r, r + 1)
            _close_rows(got["per"], served["one"][case]["per"], r, r + 1)
        else:
            _, lo, hi = rows
            for a, b in zip(got["per"], served["one"][case]["per"]):
                assert np.array_equal(a, b[:, lo:hi])
    if case in ("fork", "recurrent"):
        assert served["one"][case]["per"]  # rings / recurrent states held per slot


def _close_rows(got, one, lo, hi):
    """The one-row case's leaves: positions exact, values within 1e-5."""
    assert got
    for a, b in zip(got, one):
        b = b[:, lo:hi]
        if a.dtype == np.int32:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_fork_base_and_samples_on_different_ranks(served):
    """The fork case's four samples of one prompt sit in slots 0-3: on (4,)
    slots 0-1 on rank 0, 2-3 on rank 1, so two forks copy their base's
    rings across ranks; every sample gets one device's tokens."""
    rows = _rows("flat4", 8)
    assert [rows[0].holds(s) for s in range(4)] == [True, True, False, False]
    toks = served["one"]["fork"]["tokens"]
    assert len(toks) == 8 and toks[0] == toks[1] == toks[2] == toks[3]
    # the three samples forked their base (no prefill of their own)
    hits = served["one"]["fork"]["hits"]
    assert hits >= 3
    for key in ("flat4/fork", "hier22/fork"):
        assert all(served["port"][r][key]["hits"] == hits for r in range(4))


@pytest.mark.parametrize("mesh", list(MESH))
def test_rows_rule_is_jax_filter_axes(mesh, monkeypatch):
    from repro.parallel import sharding as jsharding

    shape, names = MESH[mesh]
    monkeypatch.setattr(jsharding, "_axis_sizes", lambda: dict(zip(names, shape)))
    jrule = RULES[mesh]["batch"]
    for n in range(1, 17):
        picked = jsharding._filter_axes(jrule, n, set())
        want = () if picked is None else (picked,) if isinstance(picked, str) else picked
        assert row_axes(paper_mesh(shape, names), RULES[mesh], n) == want, n
        rows = _rows(mesh, n)
        if not want:
            assert rows == [None] * 4
            continue
        # contiguous blocks in mesh order; ranks off the picked axes repeat them
        parts = int(np.prod([dict(zip(names, shape))[a] for a in want]))
        blocks = sorted({(s.lo, s.hi) for s in rows})
        assert blocks == [(i * n // parts, (i + 1) * n // parts) for i in range(parts)]


def test_rows_rule_cases():
    flat, hier = _rows("flat4", 3), _rows("hier22", 2)
    assert flat == [None] * 4  # 3 slots on (4,) replicate
    # 2 slots on (2, 2): the outer axis only, the inner ranks holding the same row
    assert [(s.axes, s.lo, s.hi) for s in hier] == [(("pod",), 0, 1), (("pod",), 0, 1),
                                                   (("pod",), 1, 2), (("pod",), 1, 2)]
    assert [(s.axes, s.lo, s.hi) for s in _rows("hier22", 4)] == \
        [(("pod", "data"), r, r + 1) for r in range(4)]


@pytest.mark.parametrize("n_pages", [12, 7])
def test_place_caches_cuts_slot_leaves_and_keeps_pools(n_pages):
    """gemma3's paged caches on (4,) with 8 slots: the rings cut to the
    rank's 2 rows (copies), the pools whole; ``n_pages + 1 == slots`` (7)
    replicates everything, as JAX's shape test does.  Which leaves carry a
    slot dim is JAX's ``cache_pspecs``' answer."""
    from repro.parallel import params as jparams

    cfg = make_reduced(get_config(GEMMA3))
    caches = init_paged_caches(cfg, 8, 64, n_pages=n_pages, page_size=8, kv_bits=8, device="cpu")
    jcfg = jax_make_reduced(jax_configs()[GEMMA3])
    jtree = jax.eval_shape(lambda: jm.init_paged_caches(jcfg, 8, 64, n_pages=n_pages, page_size=8,
                                                        kv_bits=8))
    fake = types.SimpleNamespace(axis_names=("data",), devices=np.empty((4,)))
    batch = -1 if n_pages + 1 == 8 else 8
    jspecs = jax.tree_util.tree_leaves(jparams.cache_pspecs(fake, jtree, batch),
                                       is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    mesh = paper_mesh((4,), ("data",), rank=1)
    specs = cache_pspecs(mesh, RULES["flat4"], caches, batch)
    flat = _flat(specs)
    assert len(flat) == len(jspecs)
    assert [isinstance(s, RowShard) for s in flat] == [len(p) > 1 and p[1] is not None
                                                      for p in jspecs]
    placed = ep.place_caches(mesh, RULES["flat4"], caches, slots=8, n_pages=n_pages)
    for t, s, full in zip(_flat(placed), flat, _flat(caches)):
        if n_pages == 7:
            assert t is full
        elif isinstance(s, RowShard):
            assert t.shape[1] == 2 and t.data_ptr() != full.data_ptr()
            assert np.array_equal(t.numpy(), full.numpy()[:, 2:4])
        else:
            assert t is full  # a pool, replicated
    rows = slot_rows(placed)
    assert (None if rows is None else (rows.lo, rows.hi)) == (None if n_pages == 7 else (2, 4))
    assert any(isinstance(s, RowShard) for s in flat) == (n_pages == 12)


def _flat(tree):
    """Every tensor (or spec) of a cache tree in JAX's flattening order:
    dict keys sorted, a ``QuantizedKV``'s (q, scale)."""
    if isinstance(tree, QuantizedKV):
        return [tree.q, tree.scale]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("rows", [None, (8, 2, 4)])
def test_decode_kernels_plan_splits_for_the_whole_step(rows):
    """Kernels 7 and 9 on a rank's 2 of 8 rows are launched with the 8-row
    split plan (``plan_rows``), so each row's split-K sums run as in one
    device's launch; outside a sharded step they plan for their own rows."""
    import torch

    from repro_torch.analysis.graph import capture
    from repro_torch.models import attention as att
    from repro_torch.parallel.sharding import use_rows
    from repro_torch.quant.kv import kv_quantize_values

    cfg = make_reduced(get_config(NLG))
    spec = cfg.layer_specs()[0].mixer
    Hkv, H, dh = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    B, T, ps, nt = 2, 16, 4, 4
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, 1, H, dh), generator=g)
    pos = torch.arange(T, dtype=torch.int32).repeat(B, 1)
    (kq, ks), (vq, vs) = (kv_quantize_values(torch.randn((B, T, Hkv, dh), generator=g))
                          for _ in range(2))
    contig = {"k": QuantizedKV(kq, ks, torch.float32), "v": QuantizedKV(vq, vs, torch.float32),
              "pos": pos}
    Pt = B * nt + 1
    pool = {"k": torch.randn((Pt, ps, Hkv, dh), generator=g),
            "v": torch.randn((Pt, ps, Hkv, dh), generator=g),
            "pos": torch.arange(ps, dtype=torch.int32).repeat(Pt, 1)}
    table = torch.arange(B * nt, dtype=torch.int32).view(B, nt)
    qpos = torch.full((B,), T - 1, dtype=torch.int32)
    shard = None if rows is None else RowShard(paper_mesh((4,), ("data",), rank=1), ("data",),
                                               *rows)
    with use_rows(shard):
        cap = capture(lambda: (att._decode_attend_quant(q, contig, qpos, spec, dh ** -0.5),
                               att._paged_decode_attend(q, pool, qpos, table, spec, dh ** -0.5)))
    want = B if rows is None else rows[0]
    assert [(r.name, r.args["plan_rows"]) for r in cap.of("kernel")] == [
        ("decode_attention_quant", want), ("paged_decode_attention", want)]
