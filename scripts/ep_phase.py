"""Phase 18 of ``chip_smoke.py``: expert-parallel serving on the card, also
runnable alone:

  python3 scripts/ep_phase.py

llama4-maverick at its published widths (D 5120, 40 / 8 heads, expert d_ff
8192, vocab 202048, the shared expert), depth cut to one (dense, MoE) repeat
as in phase 3, and the experts cut from 128 to 32, so that four ranks' trees
fit one card (each rank draws the whole 13.3 GB tree in turn, keeps its 8
experts and the replicated rest, 7.2 GB, before the next rank draws).
Every run lays the slots out as the JAX package's ``place_caches`` and
``batch`` hints do: each rank runs attention, the dense layers and the
logits on its block of the batch's rows and holds only those rows' caches
(the paged pool replicated), and gathers the sampled tokens.

  (a) 4 ranks: with 4 GPUs visible one each over NCCL, otherwise four
      processes time-sharing ``cuda:0`` over gloo (collectives staged through
      host memory), which measures correctness, not EP speed.  ``Engine``
      under ``ep_grouped`` on (4,) and under ``ep_serve`` on (2, 2) (the a2a
      prefill over the hierarchical two hops, decode replicated; a headroom
      capacity factor, so the a2a prefill drops nothing), 4 requests of 64
      tokens, 16 new, greedy; ``ContinuousEngine`` under ``ep_grouped`` on
      (4,) with 8 requests over 8 slots (2 a rank), and the contiguous one
      (``paged=False``, int8 caches: kernel 9) on (4,), which runs once more
      with every slot's caches on every rank (8 rows a launch) to tell the
      slot layout's rounding from the rest.  Tokens must equal those of
      the one-device run of the same weights in this process, and the MoE layer's output at the
      served prefill and decode inputs (each EP schedule against the
      one-device layer, within ``BF16_TOL`` of its largest value, bitwise
      or not reported).  The dropped share at the published factor 1.25
      under the a2a's per-shard capacity is reported beside it.
  (b) every rank's launches of kernels 1, 2, 4, 6, 7, 8 and 9 per path (the
      one-device counts), and the rows kernels 7 and 9 saw per launch (the
      rank's slots);
  (c) each rank's kernel 1 / 2 / 4 against its plain version at the EP
      shapes (the global gating and a shard's; the local experts' capacity
      buffer at decode and the a2a's received buffer; the masked grouped
      buffer at decode and prefill), and kernels 7 and 9 at the rank's row
      count (its two slots of the continuous traces, at their last lengths),
      and on those 2 rows of the 8-slot case bit for bit against one 8-row
      launch: equal with the 8-row split plan that a sharded step passes,
      the differing outputs counted with the 2 rows' own plan;
  (d) reduced f32 llama4 under EP on the card and on the CPU in the same
      ranks: greedy tokens identical;
  (e) a one-rank NCCL group drives ``moe_serve.ep_schedule`` (every
      schedule, on (1,) and (1, 1)) on device tensors: equal to the
      one-device layer;
  (f) each rank's parameter bytes, its cache bytes per run (the per-slot
      leaves, a quarter of one device's, and the pool, all of it) and the
      bytes and collectives staged through the host, also per step;
  (g) each run's decode step on every rank captured (``analysis/graph.py``)
      and held to its schedule's collectives, counted per MoE layer, with the
      slot layout's gathers (the rows before a replicated-token schedule, the
      new K/V of each paged layer before the pool write).

Prints its lines and, last, one JSON line with every number and the card's
name and power limit.  Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

EP_EXPERTS = 32
# the a2a prefill's headroom: at E / K the per-shard capacity is every
# assignment of the shard (cap = T_loc * K), so no routing can drop
HEADROOM_CF = float(EP_EXPERTS)
PUBLISHED_CF = 1.25
EP_CONT = dict(slots=8, capacity=1024, page_size=16, prefill_chunk=256)
EP_CONT_PROMPTS = [300, 64, 512, 128, 450, 200, 96, 384]
# the contiguous engine's run: int8 caches, so its decode goes through kernel 9
EP_CONTIG = dict(slots=8, capacity=1024, kv_cache_bits=8)
# runs of (a): name -> (engine, mesh, moe_impl, capacity factor or None)
RUNS = {
    "static_grouped_flat4": ("static", (4,), "grouped", None),
    "static_capacity_hier22": ("static", (2, 2), "ep", HEADROOM_CF),
    "continuous_grouped_flat4": ("continuous", (4,), "grouped", None),
    "contiguous_grouped_flat4": ("contiguous", (4,), "grouped", None),
}
KERNELS = ("moe_gating", "expert_mlp", "grouped_mlp", "flash_attention",
           "paged_decode_attention", "paged_prefill_attention", "decode_attention_quant")
SOURCES = ["moe_gating", "grouped_mlp", "grouped_mlp_mma", "flash_attention",
           "paged_decode_attention", "paged_prefill_attention", "decode_attention_quant"]
# the decode kernels whose rows a rank's slots set: kernel 7 (paged) and 9
# (contiguous int8)
ROW_KERNELS = ("paged_decode_attention", "decode_attention_quant")


def ep_config():
    """The phase's config: llama4-maverick at published widths, one (dense,
    MoE) repeat, 32 experts."""
    from chip_smoke import ARCH
    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_config, with_moe_ffn

    full = get_config(ARCH)
    return with_moe_ffn(full.replace(segments=(Segment(full.segments[0].pattern, 1),)),
                        num_experts=EP_EXPERTS)


def run_config(cfg, name):
    from repro_torch.configs.registry import with_capacity_factor

    _, _, impl, cf = RUNS[name]
    cfg = cfg.replace(moe_impl=impl)
    return with_capacity_factor(cfg, cf) if cf else cfg


def requests(cfg, static: bool):
    from chip_smoke import BATCH, NEW, PROMPT, SEED
    from repro_torch.serving.engine import Request

    rng = torch.Generator().manual_seed(SEED)
    if static:
        return [Request(torch.randint(0, cfg.vocab_size, (PROMPT,), generator=rng).tolist(), NEW)
                for _ in range(BATCH)]
    return [Request(torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist(), NEW)
            for n in EP_CONT_PROMPTS]


@contextlib.contextmanager
def rows_seen():
    """{kernel: Counter(rows of a launch)} of kernels 7 and 9 while open:
    the names ``models/attention.py`` calls them by, wrapped."""
    import repro_torch.models.attention as att

    seen = {k: collections.Counter() for k in ROW_KERNELS}
    orig = {k: getattr(att, k) for k in ROW_KERNELS}

    def wrap(k):
        def call(q, *a, **kw):
            seen[k][int(q.shape[0])] += 1
            return orig[k](q, *a, **kw)
        return call

    for k in ROW_KERNELS:
        setattr(att, k, wrap(k))
    try:
        yield seen
    finally:
        for k, f in orig.items():
            setattr(att, k, f)


def moe_position(cfg) -> str:
    return next(f"pos{j}" for j, ls in enumerate(cfg.segments[0].pattern) if ls.ffn.kind == "moe")


def layer_params(params, pos: str) -> dict:
    """The MoE layer's parameters of repeat 0 as the layer takes them."""
    def unstack(node):
        return {k: unstack(v) if not torch.is_tensor(v) else v[0] for k, v in node.items()}

    return unstack(params["segments"]["seg0"][pos]["moe"])


def serve(cfg, params, name, counters, device="cuda", replicate_caches=False):
    """One run of (a) on ``device``: (tokens, launches, wall seconds, the
    engine, {steps, cache bytes (per-slot, pool), rows of kernels 7 / 9,
    bytes and collectives staged through the host}) of the timed run, after
    a warm-up.  ``replicate_caches`` (the contiguous engine): every slot's
    caches on every rank, each rank running every row."""
    import chip_smoke as cs
    from repro_torch.models.model import SlotCaches, init_caches, slot_cache_bytes
    from repro_torch.parallel import collectives as col
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine, EngineConfig

    engine = RUNS[name][0] if name in RUNS else name
    reqs = requests(cfg, engine == "static")
    if engine == "static":
        eng = Engine(cfg, params, EngineConfig(max_batch=cs.BATCH, max_prefill=cs.PROMPT,
                                               max_decode=cs.NEW), device=device)
        made = []
        make = eng._make_caches
        eng._make_caches = lambda b: made.append(make(b)) or made[-1]
        eng.generate(reqs)  # warm-up
        cs.reset(*counters)
        staged0 = dict(col.staged)
        t0 = time.perf_counter()
        with rows_seen() as seen:
            tokens = [r.tokens for r in eng.generate(reqs)]
        steps, caches, paged = cs.NEW, made[-1], False
    else:
        kw = dict(paged=True, **EP_CONT) if engine == "continuous" else EP_CONTIG
        eng = ContinuousEngine(cfg, params, device=device, **kw)
        if replicate_caches:
            eng.caches = SlotCaches(init_caches(eng.cfg, kw["slots"], kw["capacity"],
                                                kv_bits=kw["kv_cache_bits"], device=device), None)
        eng.submit(type(reqs[0])(reqs[0].prompt[:100], 2))  # warm-up
        eng.run_until_done()
        eng.done.clear()
        ticks0 = len(eng.metrics_log)
        cs.reset(*counters)
        staged0 = dict(col.staged)
        t0 = time.perf_counter()
        with rows_seen() as seen:
            ids = [eng.submit(r) for r in reqs]
            done = eng.run_until_done()
        tokens = [done[i].tokens for i in ids]
        steps, caches, paged = len(eng.metrics_log) - ticks0, eng.caches, eng.paged
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items()}
    per, pool = slot_cache_bytes(eng.cfg, caches, paged)
    info = {"steps": steps, "slot_bytes": per, "pool_bytes": pool,
            "rows": {k: dict(v) for k, v in seen.items() if v},
            "staged_bytes": col.staged["bytes"] - staged0["bytes"],
            "staged_calls": col.staged["calls"] - staged0["calls"]}
    return tokens, launches, wall, eng, info


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def kernel_checks(cfg, moe, mesh, axes, gen) -> dict:
    """(c): kernels 1, 2 and 4 of this rank at the EP shapes against their
    plain versions (random tokens through the layer's router)."""
    import chip_smoke as cs
    from repro_torch.core.dispatch import dispatch_dense
    from repro_torch.core.dispatch_grouped import GROUPED_TILE, scatter_grouped
    from repro_torch.core.gating import expert_capacity, top_k_gating
    from repro_torch.kernels import expert_mlp as k2
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.kernels import moe_gating as k1
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.params import ep_rank

    E = EP_EXPERTS
    K = 1
    ep = mesh.axes_size(axes)
    E_loc = E // ep
    lo = ep_rank(mesh, axes) * E_loc
    w = (moe["wi"], moe["wg"], moe["wo"])
    assert w[0].shape[0] == E_loc, w[0].shape
    D = w[0].shape[1]
    out = {}
    for T in (4, 256):
        x = torch.randn((T, D), generator=gen, device="cuda").to(torch.bfloat16)
        logits = x.float() @ moe["router"]
        # kernel 1: the replicated global gating, and one shard's under a2a
        cap = expert_capacity(T, E, K, HEADROOM_CF)
        out[f"moe_gating_global_T{T}"] = cs.check_gating((logits, K, cap))
        T_loc = T // ep
        out[f"moe_gating_shard_T{T_loc}"] = cs.check_gating(
            (logits[:T_loc].contiguous(), K, expert_capacity(T_loc, E, K, HEADROOM_CF)))
        # kernel 4: the masked grouped buffer with this rank's experts
        g = top_k_gating(logits, K, T * K)
        lay, xg = scatter_grouped(x, g, E)
        te = lay.tile_expert
        mine = (te >= lo) & (te < lo + E_loc)
        rows = mine.repeat_interleave(GROUPED_TILE)[:, None]
        args = (torch.where(rows, xg, 0), torch.where(mine, te - lo, 0).to(torch.int32), *w,
                lay.rows_used)
        res = cs.compare_rows(f"grouped_mlp ep T{T}", gk.grouped_mlp(*args),
                              gk.grouped_mlp_plain(*args), cs.BF16_TOL)
        out[f"grouped_mlp_T{T}"] = {**res, "Ct": int(xg.shape[0]), "E_loc": E_loc}
        # kernel 2: decode's local capacity buffer (replicated schedule) or
        # the a2a's received buffer (prefill)
        if T * K <= E:
            gg, counts = k1.gating(logits, K, cap)
            m = (gg.expert_idx >= lo) & (gg.expert_idx < lo + E_loc)
            gl = gg._replace(expert_idx=torch.where(m, gg.expert_idx - lo, 0), keep=gg.keep & m,
                             combine_w=torch.where(m, gg.combine_w, 0.0))
            buf = dispatch_dense(x, gl, cap, E_loc)
            fill = counts[lo:lo + E_loc].contiguous()
            kargs = (buf, *w, fill)
            name = f"expert_mlp_replicated_T{T}"
        else:
            cap_loc = expert_capacity(T_loc, E, K, HEADROOM_CF)
            r = ep_rank(mesh, axes)
            xs = x[r * T_loc:(r + 1) * T_loc]
            gs, _ = k1.gating(xs.float() @ moe["router"], K, cap_loc)
            buf = dispatch_dense(xs, gs, cap_loc, E)
            recv = (col.hierarchical_all_to_all(buf, mesh, axes[1], axes[0]) if len(axes) == 2
                    else col.flat_all_to_all(buf, mesh, axes))
            kargs = (recv.contiguous(), *w, None)
            name = f"expert_mlp_a2a_T{T}"
        res = cs.compare_rows(name, k2.expert_mlp(*kargs), k2.expert_mlp_plain(*kargs),
                              cs.BF16_TOL)
        out[name] = {**res, "shape": list(kargs[0].shape)}
    torch.cuda.synchronize()
    return out


def row_kernel_checks(cfg, rank: int, gen) -> dict:
    """(c): kernels 7 and 9 against their plain versions at this rank's row
    count: its 2 slots of the continuous traces at their last lengths, over
    a random pool of the paged run's page size (kernel 7) and a random int8
    cache of the contiguous run's capacity (kernel 9), each held per row."""
    import chip_smoke as cs
    from repro_torch.kernels import attention_paged as k7
    from repro_torch.kernels import attention_quant as k9

    per = EP_CONT["slots"] // 4
    lens = [n + cs.NEW for n in EP_CONT_PROMPTS[rank * per:(rank + 1) * per]]
    Hkv, G, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    ps, nt = EP_CONT["page_size"], EP_CONT["capacity"] // EP_CONT["page_size"]
    pool, table, qpos = cs.synthetic_pool(lens, Hkv, dh, ps, EP_CONT["slots"] * nt + 1, nt, gen)
    args, info = cs.decode_case(pool, table, qpos, G, torch.bfloat16, gen)
    kw = dict(scale=dh ** -0.5, **info.pop("kw", {}))
    out = {"paged_decode_attention": {**info, **cs.check_paged(
        "paged_decode_attention", k7.paged_decode_attention, k7.paged_decode_attention_plain,
        args, kw, cs.BF16_TOL)}}
    T = EP_CONTIG["capacity"]
    kpos = torch.full((per, T), -1, dtype=torch.int32, device="cuda")
    for b, n in enumerate(lens):
        kpos[b, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    qpos = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device="cuda")
    args, info = cs.decode_quant_case(per, T, 0, Hkv, G, dh, torch.bfloat16, gen, kpos=kpos,
                                      qpos=qpos)
    out["decode_attention_quant"] = {**info, **cs.check_paged(
        "decode_attention_quant", k9.decode_attention_quant, k9.decode_attention_quant_plain,
        args, dict(scale=dh ** -0.5), cs.BF16_TOL)}
    torch.cuda.synchronize()
    return out


def split_plan_checks(cfg, rank: int, gen) -> dict:
    """(c): kernels 7 and 9 on this rank's 2 rows of an 8-row case (the
    continuous traces' 8 slots at their last lengths), held bit for bit
    against the same rows of one 8-row launch: with the 8-row split plan
    (``plan_rows``, as a slot-sharded step launches them) every bit must
    agree; with the 2 rows' own plan the differing outputs are counted."""
    import chip_smoke as cs
    from repro_torch.kernels import attention_paged as k7
    from repro_torch.kernels import attention_quant as k9

    n = EP_CONT["slots"]
    per = n // 4
    lo, hi = rank * per, (rank + 1) * per
    lens = [m + cs.NEW for m in EP_CONT_PROMPTS]
    Hkv, G, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    n_sm = k7._sm_count(torch.cuda.current_device())
    ps, nt = EP_CONT["page_size"], EP_CONT["capacity"] // EP_CONT["page_size"]
    pool, table, qpos = cs.synthetic_pool(lens, Hkv, dh, ps, n * nt + 1, nt, gen)
    args7, _ = cs.decode_case(pool, table, qpos, G, torch.bfloat16, gen)
    T = EP_CONTIG["capacity"]
    kpos = torch.full((n, T), -1, dtype=torch.int32, device="cuda")
    for b, m in enumerate(lens):
        kpos[b, :m] = torch.arange(m, dtype=torch.int32, device="cuda")
    qpos = torch.tensor([m - 1 for m in lens], dtype=torch.int32, device="cuda")
    args9, _ = cs.decode_quant_case(n, T, 0, Hkv, G, dh, torch.bfloat16, gen, kpos=kpos, qpos=qpos)
    out = {}
    for name, fn, args, rowed, splits in (
            ("paged_decode_attention", k7.paged_decode_attention, args7, (0, 4, 5),
             lambda b: k7.decode_splits(nt, ps, b, Hkv, n_sm)),
            ("decode_attention_quant", k9.decode_attention_quant, args9, range(7),
             lambda b: k7.decode_splits(T, 1, b, Hkv, n_sm, dh))):
        whole = fn(*args, scale=dh ** -0.5)[lo:hi]
        part = [a[lo:hi].contiguous() if i in rowed else a for i, a in enumerate(args)]
        planned = fn(*part, scale=dh ** -0.5, plan_rows=n)
        own = fn(*part, scale=dh ** -0.5)
        torch.cuda.synchronize()
        out[name] = {"rows": per, "splits_whole_plan": splits(n), "splits_own_plan": splits(per),
                     "bitwise_with_whole_plan": bool(torch.equal(planned, whole)),
                     "differing_with_own_plan": int((own != whole).sum().item()),
                     "outputs": whole.numel()}
    return out


def decode_collectives(eng, name) -> dict:
    """(g): one decode step of the engine on this rank (the contract's
    decode signature on fresh caches laid out as the engine's; the
    contiguous engine, which declares no contract, at every slot on caches
    it would place) captured, and held to its schedule's collectives,
    counted per MoE layer, with the slot layout's gathers
    (``analysis/graph.py``)."""
    from repro_torch.analysis.contracts import engine_contract
    from repro_torch.analysis.graph import audit_graph, capture, schedule_collectives
    from repro_torch.core.moe_serve import schedule_of
    from repro_torch.models import model as M
    from repro_torch.serving.ep import mesh_scope, place_caches, slot_shard

    cfg = eng.cfg
    ffn = next(ls.ffn for ls in cfg.layer_specs() if ls.ffn.kind == "moe")
    if hasattr(eng, "n_slots") and not eng.paged:
        S = T = eng.n_slots
        zeros = lambda dt: torch.zeros((S,), dtype=dt, device=eng.device)
        caches = place_caches(eng._mesh, eng._mesh_rules,
                              M.init_caches(cfg, S, eng.capacity, kv_bits=eng.kv_cache_bits,
                                            device=eng.device), slots=S)
        fn = lambda: M.ragged_decode_step(cfg, eng.params, zeros(torch.long)[:, None],
                                          zeros(torch.int32), zeros(torch.bool) | True, caches)
    else:
        dec = next(e for e in engine_contract(eng) if e.name == "decode")
        T = eng.n_slots if hasattr(eng, "n_slots") else dec.sample[-1][0]
        args = dec.make(*dec.sample[-1])
        fn = lambda: dec.fn(*args)
    schedule = schedule_of("grouped" if cfg.moe_impl == "ep_grouped" else "capacity", T, ffn)
    paged = getattr(eng, "paged", False)
    rows = slot_shard(eng._mesh, eng._mesh_rules, T, eng.n_pages if paged else None)
    allowed = schedule_collectives(cfg, schedule, eng._mesh.shape, rows.axes if rows else (),
                                   paged=paged)
    with torch.no_grad(), mesh_scope(eng._mesh, eng._mesh_rules):
        cap = capture(fn)
    rep = audit_graph(f"{name} decode", None, (), allowed_collectives=allowed, captured=cap)
    return {"schedule": schedule, "allowed": allowed, "seen": cap.collectives(),
            "rows": None if rows is None else [list(rows.axes), rows.lo, rows.hi],
            "errors": [f.render() for f in rep.errors]}


def replicated_tokens(cfg, params, counters) -> list:
    """The contiguous run of (a) again with every slot's caches on every
    rank, so that each launch takes the 8 rows one device's takes: the
    tokens, which tell the slot layout's own rounding (fewer rows a launch)
    from the rest of EP."""
    name = "contiguous_grouped_flat4"
    return serve(run_config(cfg, name).replace(ep_mesh=RUNS[name][1]), params, name, counters,
                 replicate_caches=True)[0]


def rank_body(rank: int, world: int, layer_inputs: dict) -> dict:
    """One rank of (a)-(d), (f)."""
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.core.moe import moe_layer
    from repro_torch.models.model import init_params
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import use_mesh
    from repro_torch.serving.ep import build_serving_mesh, place_params, placed_param_bytes

    counters = cs.kernel_setup()
    cfg = ep_config()
    flat, flat_rules = build_serving_mesh((4,))
    hier, hier_rules = build_serving_mesh((2, 2))
    res = {"rank": rank, "device": str(torch.cuda.current_device()), "runs": {}}
    # every rank draws the whole tree in turn and keeps its slice (the same
    # on both meshes: a rank's linear index is its global rank)
    t0 = time.perf_counter()
    params = None
    for r in range(world):
        if r == rank:
            full = init_params(cfg, seed=cs.SEED, device="cuda")
            params = place_params(flat, flat_rules, full, cfg)
            del full
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    res["draw_s"] = time.perf_counter() - t0
    res["param_bytes"] = placed_param_bytes(params)
    res["memory_allocated"] = torch.cuda.memory_allocated()
    for name, (_, shape, _, _) in RUNS.items():
        tokens, launches, wall, eng, info = serve(run_config(cfg, name).replace(ep_mesh=shape),
                                                  params, name, counters)
        res["runs"][name] = {
            "tokens": tokens, "launches": launches, "wall_s": wall, "impl": eng.cfg.moe_impl,
            **info, "collectives": decode_collectives(eng, name)}
        del eng
    res["replicated_tokens"] = replicated_tokens(cfg, params, counters)
    res["peak_memory"] = torch.cuda.max_memory_allocated()
    # the MoE layer at the served inputs under each EP schedule (the
    # one-device outputs are the parent's)
    pos = moe_position(cfg)
    moe = layer_params(params, pos)
    res["layer"] = {}
    for key, x in layer_inputs.items():
        x = torch.from_numpy(x).to("cuda", torch.bfloat16)
        for label, mesh, rules, impl, cf in (("grouped_flat4", flat, flat_rules, "ep_grouped", None),
                                             ("capacity_hier22", hier, hier_rules, "ep_serve",
                                              HEADROOM_CF)):
            spec = cfg.segments[0].pattern[int(pos[3:])].ffn
            if cf:
                spec = dataclasses.replace(spec, capacity_factor=cf)
            with use_mesh(mesh, rules):
                y, _ = moe_layer(cfg, spec, moe, x, impl=impl)
            res["layer"][f"{label}_{key}"] = y.float().cpu().numpy()  # exact
    # (c) the kernels at the EP shapes, against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 18)
    res["checks"] = {"flat4": kernel_checks(cfg, moe, flat, flat.axis_names, gen),
                     "hier22": kernel_checks(cfg, moe, hier, hier.axis_names, gen)}
    res["row_checks"] = row_kernel_checks(cfg, rank, gen)
    res["split_checks"] = split_plan_checks(cfg, rank, gen)
    del params, moe
    gc.collect()
    torch.cuda.empty_cache()
    # (d) reduced f32 under EP on the card, and on the CPU where the group
    # takes CPU tensors (gloo; over NCCL the parent runs the CPU leg)
    legs = ("cuda", "cpu") if dist.get_backend() == "gloo" else ("cuda",)
    res["reduced"] = reduced_runs(rank, legs, counters)
    res["staged_total"] = dict(col.staged)
    return res


def reduced_runs(rank: int, devices, counters=None) -> dict:
    """(d): reduced f32 llama4, drawn on the CPU, through the three runs of
    (a) under EP on each of ``devices``: {run: {device: tokens}}."""
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.models.model import init_params

    counters = counters or cs.kernel_setup()
    red = make_reduced(get_config(cs.ARCH))
    cpu_params = init_params(red, seed=cs.SEED, device="cpu")
    params = {d: cpu_params if d == "cpu" else copy.deepcopy(cpu_params).to(d) for d in devices}
    out = {}
    for name, (engine, shape, _, _) in RUNS.items():
        rcfg = run_config(red, name).replace(ep_mesh=shape)
        out[name] = {d: serve(rcfg, params[d], name, counters, device=d)[0] for d in devices}
    return out


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def one_device(cfg, counters) -> tuple:
    """The one-device runs of (a) on the same weights, the MoE layer's inputs
    at the static prefill and first decode step, and the one-device layer's
    outputs there under both dispatches."""
    import repro_torch.models.transformer as tr
    from chip_smoke import SEED
    from repro_torch.core.moe import moe_layer
    from repro_torch.models.model import init_params

    params = init_params(cfg, seed=SEED, device="cuda")
    seen = []
    orig = tr.moe_layer

    def record(c, spec, p, x, **kw):
        if len(seen) < 2:
            seen.append(x.detach().clone())
        return orig(c, spec, p, x, **kw)

    out = {}
    tr.moe_layer = record
    try:
        for name in RUNS:
            tokens, launches, wall, eng, info = serve(run_config(cfg, name), params, name, counters)
            out[name] = {"tokens": tokens, "launches": launches, "wall_s": wall, **info}
            del eng
    finally:
        tr.moe_layer = orig
    # the first two calls of the warm-up generate: prefill [4, 64, D], decode
    # [4, 1, D]; the ranks get them as f32 arrays (exact)
    inputs = {"prefill": seen[0], "decode": seen[1]}
    pos = moe_position(cfg)
    moe = layer_params(params, pos)
    spec = cfg.segments[0].pattern[int(pos[3:])].ffn
    layer = {}
    hspec = dataclasses.replace(spec, capacity_factor=HEADROOM_CF)
    for key, x in inputs.items():
        layer[f"grouped_flat4_{key}"] = moe_layer(cfg, spec, moe, x, impl="grouped")[0].float().cpu()
        layer[f"capacity_hier22_{key}"] = moe_layer(cfg, hspec, moe, x, impl="dense")[0].float().cpu()
    drops = dropped_shares(inputs["prefill"], moe["router"], spec)
    inputs = {k: v.float().cpu().numpy() for k, v in inputs.items()}
    del params, moe
    gc.collect()
    torch.cuda.empty_cache()
    return out, inputs, layer, drops


def dropped_shares(x, router, spec) -> dict:
    """The share of the a2a prefill's assignments dropped by its per-shard
    capacity on (2, 2), at the published factor and at the headroom one."""
    from repro_torch.core.gating import expert_capacity, top_k_gating

    xs = x.reshape(-1, x.shape[-1])
    T_loc = xs.shape[0] // 4
    out = {}
    for cf in (PUBLISHED_CF, HEADROOM_CF):
        kept = total = 0
        for r in range(4):
            logits = xs[r * T_loc:(r + 1) * T_loc].float() @ router
            g = top_k_gating(logits, spec.top_k, expert_capacity(T_loc, spec.num_experts,
                                                                 spec.top_k, cf))
            kept += int(g.keep.sum().item())
            total += g.keep.numel()
        out[str(cf)] = (total - kept) / total
    return out


def nccl_one_rank(cfg, gen) -> dict:
    """(e): a one-rank NCCL group; every schedule on (1,) and (1, 1) through
    device tensors against the one-device layer at llama4's expert width."""
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.core.moe import moe_layer
    from repro_torch.core.moe_serve import ep_schedule
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import make_ep_mesh
    from repro_torch.serving.ep import RENDEZVOUS_DIR

    RENDEZVOUS_DIR.mkdir(parents=True, exist_ok=True)
    store = RENDEZVOUS_DIR / f"nccl-one-rank-{time.time_ns()}"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        # the routed experts alone (the shared expert is a replicated dense MLP)
        spec = dataclasses.replace(cfg.segments[0].pattern[int(moe_position(cfg)[3:])].ffn,
                                   capacity_factor=HEADROOM_CF, residual=False)
        E, D, F = spec.num_experts, cfg.d_model, spec.d_ff
        scale = lambda n: n ** -0.5
        moe = {"router": torch.randn((D, E), generator=gen, device="cuda") * scale(D),
               "wi": (torch.randn((E, D, F), generator=gen, device="cuda") * scale(D)).bfloat16(),
               "wg": (torch.randn((E, D, F), generator=gen, device="cuda") * scale(D)).bfloat16(),
               "wo": (torch.randn((E, F, D), generator=gen, device="cuda") * scale(F)).bfloat16()}
        staged0 = col.staged["bytes"]
        out = {"backend": dist.get_backend()}
        for shape, names in (((1,), ("data",)), ((1, 1), ("pod", "data"))):
            mesh = make_ep_mesh(shape, names)
            for schedule, T, impl in (("replicated_dense", 4, "dense"),
                                      ("replicated_grouped", 4, "grouped"),
                                      ("replicated_grouped", 256, "grouped"),
                                      ("a2a", 256, "dense")):
                x = torch.randn((4, T // 4, D), generator=gen, device="cuda").bfloat16()
                y, _ = ep_schedule(schedule, spec, moe, x, mesh, names)
                want, _ = moe_layer(cfg, spec, moe, x, impl=impl)
                res = cs.compare(f"{schedule} T{T} on {shape}", y, want, cs.BF16_TOL)
                res["bitwise"] = bool(torch.equal(y, want))
                out[f"{'x'.join(map(str, shape))}/{schedule}_T{T}"] = res
        out["staged_bytes"] = col.staged["bytes"] - staged0
        del moe
        return out
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def layer_agreement(ep_out, one) -> dict:
    """The EP layer's output against the one-device layer's: max |d|
    relative to the largest one-device value (within ``BF16_TOL``), and
    whether every bit agrees."""
    import chip_smoke as cs

    res = cs.compare("ep layer", ep_out, one, cs.BF16_TOL)
    res["bitwise"] = bool(torch.equal(ep_out, one))
    return res


def ep_phase(counters) -> tuple:
    """Phase 18.  Returns (lines, summary, launches by path of rank 0)."""
    import chip_smoke as cs
    from repro_torch.serving import ep

    lines = []
    cfg = ep_config()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref, inputs, one_layer, drops = one_device(cfg, counters)
    lines.append(f"ep: one-device reference ({EP_EXPERTS} experts, {cfg.d_model} wide) in "
                 f"{time.perf_counter() - t0:.1f} s; a2a prefill dropped share on (2, 2): "
                 f"{drops[str(PUBLISHED_CF)]:.4f} at capacity factor {PUBLISHED_CF}, "
                 f"{drops[str(HEADROOM_CF)]:.4f} at {HEADROOM_CF}")
    if drops[str(HEADROOM_CF)]:
        raise AssertionError(f"the headroom capacity factor {HEADROOM_CF} dropped {drops}")
    nccl = torch.cuda.device_count() >= 4
    backend = "nccl" if nccl else "gloo"
    transport = ("NCCL, one GPU per rank" if nccl else
                 "gloo, four processes time-sharing cuda:0, collectives staged through host memory")
    t0 = time.perf_counter()
    ranks = ep.launch(rank_body, 4, backend=backend, args=(4, inputs), timeout_s=900)
    lines.append(f"ep: 4 ranks over {transport} in {time.perf_counter() - t0:.1f} s "
                 f"(draws, three runs, kernel checks, reduced references)")
    summary = {"transport": transport, "experts": EP_EXPERTS, "dropped_share": drops, "runs": {},
               "ranks": [{k: r[k] for k in ("rank", "device", "draw_s", "param_bytes",
                                            "memory_allocated", "peak_memory", "staged_total")}
                         for r in ranks]}
    by_path = {}
    for name in RUNS:
        toks = [r["runs"][name]["tokens"] for r in ranks]
        if any(t != toks[0] for t in toks):
            raise AssertionError(f"ep {name}: the ranks' tokens differ")
        launches = [{k: r["runs"][name]["launches"][k] for k in KERNELS} for r in ranks]
        if any(lz != launches[0] for lz in launches):
            raise AssertionError(f"ep {name}: the ranks' launches differ: {launches}")
        one = {k: ref[name]["launches"][k] for k in KERNELS}
        impl = ranks[0]["runs"][name]["impl"]
        # the one-device calls, one a layer and step: under ep_serve kernel 1
        # gates the rank's shard at prefill and every token at decode
        if launches[0] != one:
            raise AssertionError(f"ep {name}: launches {launches[0]}, one device {one}")
        for k in ("moe_gating", "expert_mlp", "grouped_mlp"):
            if (k == "grouped_mlp") == (impl == "ep_grouped") and not launches[0][k]:
                raise AssertionError(f"ep {name}: kernel {k} never launched")
        by_path[f"ep_{name}"] = launches[0]
        same = toks[0] == ref[name]["tokens"]
        n_diff = sum(a != b for ta, tb in zip(toks[0], ref[name]["tokens"]) for a, b in zip(ta, tb))
        run = ranks[0]["runs"][name]
        summary["runs"][name] = {
            "impl": impl, "tokens_identical_to_one_device": same, "tokens_differing": n_diff,
            "launches_per_rank": launches[0], "one_device_launches": one,
            "wall_s_per_rank": [r["runs"][name]["wall_s"] for r in ranks],
            "one_device_wall_s": ref[name]["wall_s"],
            "staged_bytes_per_rank": run["staged_bytes"], "staged_calls_per_rank": run["staged_calls"]}
        lines.append(f"ep {name} ({impl}): tokens {'identical to' if same else 'differ from'} the "
                     f"one-device run ({n_diff} of {sum(map(len, toks[0]))} differ), all 4 ranks "
                     f"equal; launches per rank {launches[0]}; wall {run['wall_s']:.3f} s on rank 0 "
                     f"(one device {ref[name]['wall_s']:.3f} s); staged {run['staged_bytes']} "
                     f"bytes in {run['staged_calls']} collectives")
        lines.append(f"ep {name}: tokens of request 0 {toks[0][0]}")
        # the slot layout: per-slot cache bytes a quarter of one device's
        # where the rows shard over the 4 ranks, the pool whole; kernels 7
        # and 9 on the rank's rows; the host-staged traffic a step
        cache = [(r["runs"][name]["slot_bytes"], r["runs"][name]["pool_bytes"]) for r in ranks]
        one_c = (ref[name]["slot_bytes"], ref[name]["pool_bytes"])
        if any(c != (one_c[0] // 4, one_c[1]) for c in cache) or one_c[0] % 4:
            raise AssertionError(f"ep {name}: cache bytes a rank {cache}, one device {one_c}")
        rows = [r["runs"][name]["rows"] for r in ranks]
        want_rows = {k: {n // 4: c for n, c in v.items()} for k, v in ref[name]["rows"].items()}
        if any(rw != want_rows for rw in rows):
            raise AssertionError(f"ep {name}: rows of kernels 7 / 9 {rows}, one device "
                                 f"{ref[name]['rows']}")
        steps = run["steps"]
        summary["runs"][name].update(
            slot_bytes_per_rank=cache[0][0], pool_bytes_per_rank=cache[0][1],
            one_device_slot_bytes=one_c[0], one_device_pool_bytes=one_c[1],
            rows_per_launch=rows[0], one_device_rows_per_launch=ref[name]["rows"], steps=steps,
            staged_bytes_per_step=run["staged_bytes"] / steps,
            staged_calls_per_step=run["staged_calls"] / steps)
        lines.append(f"ep cache bytes {name}: a rank per-slot {cache[0][0]} pool {cache[0][1]} "
                     f"total {sum(cache[0])}; one device per-slot {one_c[0]} pool {one_c[1]} "
                     f"total {sum(one_c)} (per-slot a rank = one device / 4 on every rank)")
        lines.append(f"ep rows {name}: kernels 7 / 9 launches by rows a launch, a rank {rows[0]}, "
                     f"one device {ref[name]['rows']}; staged {run['staged_bytes'] / steps:.0f} "
                     f"bytes in {run['staged_calls'] / steps:.2f} collectives a step over "
                     f"{steps} steps")
        colls = [r["runs"][name]["collectives"] for r in ranks]
        if any(c["errors"] for c in colls) or any(c["seen"] != colls[0]["seen"] for c in colls):
            raise AssertionError(f"ep {name}: decode collectives {colls}")
        summary["runs"][name]["decode_collectives"] = colls[0]
        lines.append(f"graph audit: ep {name}: every rank's decode step makes {colls[0]['seen']}: "
                     f"the {colls[0]['schedule']} schedule's collectives over "
                     f"{RUNS[name][1]}, counted per MoE layer ({colls[0]['allowed']})")
    # the contiguous run with the caches replicated (8 rows a launch)
    name = "contiguous_grouped_flat4"
    rep_toks = [r["replicated_tokens"] for r in ranks]
    if any(t != rep_toks[0] for t in rep_toks):
        raise AssertionError(f"ep {name} replicated: the ranks' tokens differ")
    n_rep = sum(a != b for ta, tb in zip(rep_toks[0], ref[name]["tokens"]) for a, b in zip(ta, tb))
    summary["runs"][name]["replicated_caches_tokens_differing"] = n_rep
    lines.append(f"ep {name} with every slot's caches on every rank (8 rows a launch, as one "
                 f"device): {n_rep} of {sum(map(len, rep_toks[0]))} tokens differ from the "
                 f"one-device run; slot-sharded (2 rows a launch): "
                 f"{summary['runs'][name]['tokens_differing']}")
    bad = {name: s["tokens_differing"] for name, s in summary["runs"].items() if s["tokens_differing"]}
    if bad:
        for line in lines:
            cs.log(line)
        raise AssertionError(f"ep: tokens differ from the one-device run's in {bad}")
    # the MoE layer's output: every rank's EP schedule against one device
    summary["layer"] = {}
    for key, one in one_layer.items():
        outs = [torch.from_numpy(r["layer"][key]) for r in ranks]
        if any(not torch.equal(o, outs[0]) for o in outs):
            raise AssertionError(f"ep layer {key}: the ranks' outputs differ")
        summary["layer"][key] = layer_agreement(outs[0], one)
    lines.append("ep layer output against one device (relative to its largest value): " +
                 json.dumps(summary["layer"]))
    # (c), (d), (f)
    summary["checks"] = {f"rank{r['rank']}": {**r["checks"], "rows": r["row_checks"]}
                         for r in ranks}
    for r in ranks:
        for mesh, checks in r["checks"].items():
            lines.append(f"ep kernels rank {r['rank']} {mesh}: " + json.dumps(
                {k: {kk: v[kk] for kk in ("max_abs_err", "max_rel_err") if kk in v}
                 for k, v in checks.items()}))
    if "cpu" not in ranks[0]["reduced"][next(iter(RUNS))]:
        cpu = ep.launch(reduced_runs, 4, backend="gloo", args=(("cpu",),), timeout_s=600)
        for r, c in zip(ranks, cpu):
            for name in RUNS:
                r["reduced"][name]["cpu"] = c[name]["cpu"]
    for name in RUNS:
        for r in ranks:
            got = r["reduced"][name]
            if got["cuda"] != got["cpu"] or got["cuda"] != ranks[0]["reduced"][name]["cuda"]:
                raise AssertionError(f"ep reduced f32 {name} rank {r['rank']}: card {got['cuda']} "
                                     f"vs CPU {got['cpu']}")
    summary["reduced_card_vs_cpu"] = "identical"
    lines.append(f"ep reduced f32 llama4 card vs CPU, 4 ranks, {', '.join(RUNS)}: greedy tokens "
                 "identical")
    for r in ranks:
        keys = ("B", "max_abs_err", "max_row_rel_err", "pairs")
        lines.append(f"ep kernels 7 / 9 rank {r['rank']} at its {EP_CONT['slots'] // 4} rows: " +
                     json.dumps({k: {kk: v[kk] for kk in keys if kk in v}
                                 for k, v in r["row_checks"].items()}))
    summary["split_plans"] = {f"rank{r['rank']}": r["split_checks"] for r in ranks}
    for r in ranks:
        lines.append(f"ep kernels 7 / 9 rank {r['rank']}, its {EP_CONT['slots'] // 4} rows against "
                     f"the same rows of an {EP_CONT['slots']}-row launch: " +
                     json.dumps(r["split_checks"]))
        if not all(v["bitwise_with_whole_plan"] for v in r["split_checks"].values()):
            raise AssertionError(f"ep rank {r['rank']}: kernels 7 / 9 on its rows with the whole "
                                 f"step's split plan differ from one launch over every row")
    for r in ranks:
        lines.append(f"ep rank {r['rank']} (device {r['device']}): {r['param_bytes'] / 1e9:.2f} GB "
                     f"of parameters, {r['peak_memory'] / 1e9:.1f} GB peak, staged "
                     f"{r['staged_total']['bytes']} bytes in {r['staged_total']['calls']} "
                     f"collectives, drew its tree in turn ({r['draw_s']:.1f} s to the last barrier)")
    # (e) one NCCL rank on device tensors
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 19)
    summary["nccl_one_rank"] = nccl_one_rank(cfg, gen)
    lines.append("ep one-rank NCCL group, every schedule against the one-device layer: " +
                 json.dumps(summary["nccl_one_rank"]))
    gc.collect()
    torch.cuda.empty_cache()
    return lines, summary, by_path


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("ep_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build

    counters = cs.kernel_setup()
    build.build(SOURCES)
    lines, summary, by_path = ep_phase(counters)
    for line in lines:
        cs.log(line)
    cs.log(json.dumps({"ep": summary, "launches_by_path": by_path, "card": cs.nvidia_smi_line()},
                      default=str))
    return 0


if __name__ == "__main__":
    # the ranks unpickle their body by this module's importable name
    import ep_phase

    sys.exit(ep_phase.main())
