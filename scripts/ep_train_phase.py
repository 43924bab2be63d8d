"""Phase 19 of ``chip_smoke.py``: expert-parallel training on the card, also
runnable alone:

  python3 scripts/ep_train_phase.py

One process per rank (``serving.ep.launch``): with as many GPUs visible as
ranks, one each over NCCL; otherwise the ranks time-share ``cuda:0`` over
gloo (collectives staged through host memory), which shows correctness, not
EP speed.  Each rank trains ``moe_impl="ep"`` (``core/moe_parallel.py``:
kernels 1 / 1b, 2 / 2b for SwiGLU experts, 6 / 6b in attention) with ZeRO-1
AdamW (``training/optimizer.py``) on its rows of the Markov stream.

  (a) llama4-maverick at its published widths (D 5120, 40 / 8 heads, expert
      d_ff 8192, dense d_ff 16384, vocab 202048, the shared expert), cut in
      depth to one (dense, MoE) repeat and in experts from 128 to 8, on the
      mesh (2,) over ``data``: 3 AdamW steps of 4 x 512 tokens at the
      capacity factor E / K = 8 (the headroom: a shard's capacity takes
      every assignment),
      held against a one-device run of the same weights and batches (run
      first in this process and freed): every step's loss and grad norm and
      a digest of three leaves after step 3 (an expert shard, the router,
      the embedding) within ``BF16_TOL``, and each leaf's update (after less
      before) within ``UPDATE_L2_TOL`` and ``UPDATE_SIGN_MIN`` of the one
      device's; then 3 steps at the published
      factor 1.25 with the dropped share under per-shard capacity;
  (b) nlg-350m-prmoe-32-64 at its published size on (2, 2) over (``data``,
      ``model``), its GELU experts sliced over ``model``: 2 steps of 8 x 512
      tokens at each layer's E / K against its one-device run, and one at the
      published 1.25; every layer recomputed in the backward (``remat``), on
      one device and on the ranks alike: at E / K every layer's expert
      activations would not fit the card at once;
  (c) reduced f32 llama4 on (2,) and PR-MoE on (2, 2) under EP on the card
      and on the CPU in the same ranks: losses and every leaf after 3 steps;
  (d) every rank's launches of 1, 1b, 2, 2b, 6 and 6b per run against the
      one-device counts (``train_want``); each llama4 rank's kernels 2 / 2b
      against their plain versions per row at the received [4, 2 * cap,
      5120] buffer of a real exchange, at d_ff 8192 and at the slice 4096,
      and 1 / 1b at the shard's 1024 tokens;
  (e) per rank: parameter and moment bytes, peak memory, bytes staged
      through the host, step ms on the host clock ("time-shared: not EP
      speed" under gloo).

Prints its lines, the phase's wall time, and last one JSON line with every
number and the card's name and power limit.  Needs the card; imports
nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src", ROOT / "scripts"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CARD = "cuda"
PUBLISHED_CF = 1.25
# model -> (mesh shape, axis names, experts kept or None, global batch,
#           seq, steps, remat)
MODELS = {
    "llama4": ((2,), ("data",), 8, 4, 512, 3, False),
    "prmoe": ((2, 2), ("data", "model"), None, 8, 512, 2, True),
}
# run -> capacity factor (None: each layer's E / K, the headroom: a shard's
# capacity takes every assignment, so nothing drops)
RUNS = {"headroom": None, "published": PUBLISHED_CF}
# PR-MoE's run at the published factor reports the dropped share under
# per-shard capacity, peak and staged bytes, which one step measures (it
# keeps chip_smoke.py within its time); llama4's takes its own steps
PUBLISHED_STEPS = {"prmoe": 1}


def run_steps(model: str, run: str) -> int:
    if run == "published":
        return PUBLISHED_STEPS.get(model, MODELS[model][5])
    return MODELS[model][5]


REDUCED = {"llama4": "llama4-maverick-400b-a17b", "prmoe": "nlg-350m-prmoe-32-64"}
RED_BATCH, RED_SEQ = 8, 32
KERNELS = ("moe_gating", "moe_gating_backward", "expert_mlp", "expert_mlp_backward",
           "flash_attention", "flash_attention_backward")
SOURCES = ["moe_gating", "grouped_mlp", "grouped_mlp_bwd", "flash_attention", "flash_attention_bwd"]
DIGEST_POINTS = 4096
# Each sampled leaf's update against the one device's (the check of the
# ZeRO-1 step: the values themselves move by ~lr a step, well inside
# BF16_TOL).  A zero or stale update reads a relative L2 difference of 1.0
# and agrees in sign nowhere; the runs read at most 0.30 and at least 93%
# (PERF.md §6), bf16 rounding of a ~1e-4 step.
UPDATE_L2_TOL = 0.5
UPDATE_SIGN_MIN = 0.85


def model_config(model: str, cf):
    """(a)'s llama4 cut or (b)'s PR-MoE at its published size, every MoE
    layer at capacity factor ``cf`` (None: its own E / K), under
    ``moe_impl="ep"``."""
    from chip_smoke import ARCH, TRAIN_ARCH
    from repro_torch.configs.base import Segment
    from repro_torch.configs.registry import get_config, with_capacity_factor, with_moe_ffn

    if model == "llama4":
        full = get_config(ARCH)
        cfg = with_moe_ffn(full.replace(segments=(Segment(full.segments[0].pattern, 1),)),
                           num_experts=MODELS[model][2])
    else:
        cfg = get_config(TRAIN_ARCH)
    if cf is None:
        import dataclasses

        from repro_torch.configs.base import Segment

        head = lambda ls: dataclasses.replace(ls, ffn=dataclasses.replace(
            ls.ffn, capacity_factor=ls.ffn.num_experts / ls.ffn.top_k)) \
            if ls.ffn.kind == "moe" else ls
        segs = tuple(Segment(tuple(head(ls) for ls in seg.pattern), seg.repeats)
                     for seg in cfg.segments)
        return cfg.replace(segments=segs, moe_impl="ep")
    return with_capacity_factor(cfg, cf).replace(moe_impl="ep")


def train_config(model: str, steps: int):
    import chip_smoke as cs
    from repro_torch.training.trainer import TrainConfig

    return TrainConfig(lr=cs.TRAIN_LR, warmup_steps=1, decay_steps=steps, remat=MODELS[model][6])


def digest_leaves(leaves: dict) -> dict:
    """The three leaves of (a) / (b)'s digest: the first routed experts'
    ``wi``, that layer's router, the embedding."""
    wi = next(k for k in leaves if k.endswith("/moe/wi"))
    return {"expert_wi": wi, "router": wi[:-2] + "router", "embed": "embed"}


def digest(t: torch.Tensor) -> dict:
    """Values at DIGEST_POINTS evenly spaced positions (a numpy array: what
    a rank returns crosses a pipe) and the f64 sum of squares."""
    flat = t.detach().reshape(-1)
    idx = torch.arange(DIGEST_POINTS, device=flat.device) * (flat.numel() - 1) // (DIGEST_POINTS - 1)
    return {"sample": flat[idx].float().cpu().numpy(), "sumsq": float(flat.double().square().sum())}


def shard_of(t: torch.Tensor, path: str, cfg, mesh_shape, names, rank) -> torch.Tensor:
    """The slice of a one-device expert leaf that ``rank`` holds
    (``shard_params(mode="train")``'s cut)."""
    from repro_torch.parallel.params import f_dim, layer_ffn
    from repro_torch.parallel.sharding import coords_of

    coords = dict(zip(names, coords_of(rank, mesh_shape)))
    sizes = dict(zip(names, mesh_shape))
    keys = path.split("/")
    E_loc = layer_ffn(cfg, keys).num_experts // sizes["data"]
    t = t.narrow(1, coords["data"] * E_loc, E_loc)
    if "model" in sizes:
        fd = f_dim(keys, t.dim())
        n = t.shape[fd] // sizes["model"]
        t = t.narrow(fd, coords["model"] * n, n)
    return t.contiguous()


@contextlib.contextmanager
def recorded_drops(into: list):
    """Wrap the gating that ``core/moe_parallel.py`` (under a mesh) and
    ``core/moe.py`` (one device) call: each call's kept and total
    assignments (device counts, read at the end)."""
    import repro_torch.core.moe as moe
    import repro_torch.core.moe_parallel as mp

    origs = {m: m.gating for m in (moe, mp)}

    def wrap(orig):
        def record(logits, K, cap, **kw):
            g, counts = orig(logits, K, cap, **kw)
            into.append((g.keep.sum(), g.keep.numel()))
            return g, counts
        return record

    for m, orig in origs.items():
        m.gating = wrap(orig)
    try:
        yield
    finally:
        for m, orig in origs.items():
            m.gating = orig


class Lines(list):
    """The phase's lines, each printed as it comes (a failure later keeps
    what came before)."""

    def append(self, line):
        import chip_smoke as cs

        cs.log(line)
        super().append(line)


def train_run(cfg, steps, batch, seq, step_fn, params, state, data, counters, what):
    """``steps`` steps on the host clock, each ending in a sync; launches and
    the per-shard dropped share over them."""
    import chip_smoke as cs

    rows, ms, drops = [], [], []
    cs.reset(*counters)
    with recorded_drops(drops):
        for _ in range(steps):
            toks, labels = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, toks, labels)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: float(v) for k, v in m.items()})
    got = cs.read(counters, what)
    kept = sum(int(k) for k, _ in drops)
    total = sum(n for _, n in drops)
    if not total:
        raise AssertionError(f"{what}: no MoE layer gated")
    return rows, ms, got, 1 - kept / total, params, state


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def kernel_checks(cfg, mesh, gen) -> dict:
    """(d), llama4: kernel 1 at the shard's tokens, 1b there, and kernels 2
    / 2b at the buffer a real exchange delivers, at the experts' d_ff (8192)
    and half of it (the slice over a 2-wide ``model`` axis)."""
    import chip_smoke as cs
    from repro_torch.core.dispatch import dispatch_dense
    from repro_torch.core.gating import expert_capacity
    from repro_torch.kernels import expert_mlp as k2
    from repro_torch.kernels import expert_mlp_grouped as gk
    from repro_torch.kernels import moe_gating as k1
    from repro_torch.launch import training_kernels as tk
    from repro_torch.parallel import collectives as col

    batch, seq = MODELS["llama4"][3:5]
    spec = next(ls.ffn for ls in cfg.layer_specs() if ls.ffn.kind == "moe")
    ep = mesh.axis_size("data")
    E = spec.num_experts
    E_loc, D, F, K = E // ep, cfg.d_model, spec.d_ff, spec.top_k
    T_loc = batch * seq // ep
    rnd = lambda *s: torch.randn(s, generator=gen, device=CARD)
    w = {"wi": (rnd(E_loc, D, F) * D ** -0.5).bfloat16(), "wg": (rnd(E_loc, D, F) * D ** -0.5).bfloat16(),
         "wo": (rnd(E_loc, F, D) * F ** -0.5).bfloat16()}
    router = rnd(D, E) * D ** -0.5
    x = rnd(T_loc, D).bfloat16()
    out = {}
    for cf in (E / K, PUBLISHED_CF):
        cap = expert_capacity(T_loc, E, K, cf)
        logits = x.float() @ router
        out[f"moe_gating_T{T_loc}_cf{cf}"] = cs.check_gating((logits, K, cap))
        res = tk.check_gating_bwd(f"ep_T{T_loc}", T_loc, E, K, cf, 0.0, gen, timed=False)
        if not res["ok"]:
            raise AssertionError(f"kernel 1b at the shard's {T_loc} tokens: {res}")
        out[f"moe_gating_backward_T{T_loc}_cf{cf}"] = res
        g, _ = k1.gating(logits, K, cap)
        recv = col.flat_all_to_all(dispatch_dense(x, g, cap, E), mesh, "data").contiguous()
        for f_loc in (F, F // 2):
            wi, wg = w["wi"][..., :f_loc].contiguous(), w["wg"][..., :f_loc].contiguous()
            wo = w["wo"][:, :f_loc].contiguous()
            key = f"{list(recv.shape)}_F{f_loc}"
            res = cs.compare_rows(f"expert_mlp ep {key}", k2.expert_mlp(recv, wi, wg, wo, None),
                                  k2.expert_mlp_plain(recv, wi, wg, wo, None), cs.BF16_TOL)
            out[f"expert_mlp_{key}"] = {**res, "shape": list(recv.shape), "F": f_loc}
            dy = rnd(*recv.shape).bfloat16()
            grads = k2.expert_mlp_backward(recv, wi, wg, wo, dy, None)
            refs = k2.expert_mlp_backward_plain(recv, wi, wg, wo, dy, None)
            res = {"shape": list(recv.shape), "F": f_loc,
                   "variant": gk.backward_variant(torch.bfloat16, D, f_loc)}
            for gname, gg, r in zip(("dx", "dwi", "dwg", "dwo"), grads, refs):
                res[gname] = tk.grad_rows(gg.reshape(-1, gg.shape[-1]), r.reshape(-1, r.shape[-1]))
                if not res[gname].get("finite", True) or \
                        res[gname]["max_row_rel_err"] > tk.BWD_TOL[torch.bfloat16]:
                    raise AssertionError(f"kernel 2b at {key}: {gname} {res[gname]}")
            res["max_abs_err"] = max((a.float() - b.float()).abs().max().item()
                                     for a, b in zip(grads, refs))
            out[f"expert_mlp_backward_{key}"] = res
            del grads, refs
    torch.cuda.synchronize()
    return out


def reduced_runs(rank: int, model: str, devices) -> dict:
    """(c): the reduced f32 model under EP on each of ``devices`` (``card``,
    ``cpu``) from the same initial tree: {device: (losses, leaves)}."""
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config, make_reduced
    from repro_torch.models.model import init_params, param_leaves
    from repro_torch.training.ep import train_rank
    from repro_torch.training.trainer import TrainConfig

    shape, names = MODELS[model][:2]
    cfg = make_reduced(get_config(REDUCED[model])).replace(moe_impl="ep")
    cpu = init_params(cfg, seed=cs.SEED + 19, device="cpu")
    tc = TrainConfig(lr=cs.REF_LR, warmup_steps=1, decay_steps=cs.REF_STEPS)
    out = {}
    for leg in devices:
        dev = CARD if leg == "card" else "cpu"
        p = copy.deepcopy(cpu).to(dev) if leg == "card" else cpu
        res = train_rank(rank, cfg, shape, names, tc, cs.REF_STEPS, RED_BATCH, RED_SEQ,
                         seed=cs.SEED, device=dev, params=p)
        out[leg] = ([h["loss"] for h in res["history"]],
                    {k: v.detach().cpu().numpy() for k, v in param_leaves(res["params"]).items()})
    return out


def rank_body(rank: int, model: str) -> dict:
    """One rank of (a) or (b), with (c)-(e)."""
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.data.pipeline import data_stream
    from repro_torch.models.model import param_leaves
    from repro_torch.parallel import collectives as col
    from repro_torch.quant.ptq import tree_bytes
    from repro_torch.training.ep import build_train_mesh, draw_placed
    from repro_torch.training.trainer import init_opt_state, make_train_step

    counters = cs.kernel_setup()
    shape, names = MODELS[model][:2]
    mesh, rules = build_train_mesh(shape, names)
    res = {"rank": rank, "device": str(torch.cuda.current_device()), "runs": {}}
    batch, seq = MODELS[model][3:5]
    for run, cf in RUNS.items():
        steps = run_steps(model, run)
        tc = train_config(model, steps)
        cfg = model_config(model, cf)
        t0 = time.perf_counter()
        params = draw_placed(cfg, mesh, rules, cs.SEED, CARD)
        draw_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, tc, mesh=mesh, rules=rules)
        state = init_opt_state(params, step.dist_ctx)
        leaves = param_leaves(params)
        names3 = digest_leaves(leaves)
        before = {k: digest(leaves[p]) for k, p in names3.items()}
        data = data_stream(cfg.vocab_size, batch, seq, seed=cs.SEED, device=CARD, mesh=mesh,
                           rules=rules)
        staged0 = dict(col.staged)
        rows, ms, got, dropped, params, state = train_run(
            cfg, steps, batch, seq, step, params, state, data, counters, f"ep_train_{model}_{run}")
        want = cs.train_want(cfg, got, steps, remat=tc.remat)
        if got != want:
            raise AssertionError(f"ep train {model} {run} rank {rank}: launches {got}, "
                                 f"expected {want}")
        leaves = param_leaves(params)
        res["runs"][run] = {
            "cf": cf or "E / K", "tokens": [batch, seq], "rows": rows, "ms": ms, "launches": {k: got[k] for k in KERNELS},
            "dropped_share": dropped, "draw_s": draw_s,
            "param_bytes": tree_bytes(params),
            "moment_bytes": tree_bytes(state.m) + tree_bytes(state.v),
            "peak_memory": torch.cuda.max_memory_allocated(),
            "staged_bytes": col.staged["bytes"] - staged0["bytes"],
            "staged_calls": col.staged["calls"] - staged0["calls"],
            "digest_before": before,
            "digest": {k: digest(leaves[p]) for k, p in names3.items()}, "digest_paths": names3}
        del params, state, step, leaves, data
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    if model == "llama4":
        gen = torch.Generator(device=CARD).manual_seed(cs.SEED + 20 + rank)
        res["checks"] = kernel_checks(model_config(model, None), mesh, gen)
        gc.collect()
        torch.cuda.empty_cache()
    legs = ("card", "cpu") if dist.get_backend() == "gloo" else ("card",)
    res["reduced"] = reduced_runs(rank, model, legs)
    res["staged_total"] = dict(col.staged)
    return res


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def one_device(model: str, counters) -> dict:
    """The one-device run of (a) / (b)'s headroom case: losses, grad norms,
    launches, step ms, peak memory, and the digests of every rank's slice
    of the three leaves before and after the steps."""
    import chip_smoke as cs
    from repro_torch.data.pipeline import data_stream
    from repro_torch.models.model import init_params, param_leaves, trainable
    from repro_torch.training.trainer import init_opt_state, make_train_step

    shape, names = MODELS[model][:2]
    batch, seq, steps = MODELS[model][3:6]
    cfg = model_config(model, None)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=cs.SEED, device=CARD)
    state = init_opt_state(params)
    leaves = param_leaves(params)
    names3 = digest_leaves(leaves)
    world = 1
    for n in shape:
        world *= n

    def digests():
        out = {}
        for r in range(world):
            out[r] = {k: digest(shard_of(leaves[p], p, cfg, shape, names, r) if k == "expert_wi"
                                else leaves[p]) for k, p in names3.items()}
        return out

    before = digests()
    step = make_train_step(cfg, train_config(model, steps))
    data = data_stream(cfg.vocab_size, batch, seq, seed=cs.SEED, device=CARD)
    rows, ms, got, dropped, params, state = train_run(cfg, steps, batch, seq, step, params, state,
                                                      data, counters, f"ep_train_{model}_one")
    leaves = param_leaves(params)
    out = {"rows": rows, "ms": ms, "launches": {k: got[k] for k in KERNELS},
           "dropped_share": dropped, "peak_memory": torch.cuda.max_memory_allocated(),
           "digest_before": before, "digest": digests(), "params": len(leaves),
           "param_count": sum(t.numel() for t in leaves.values())}
    trainable(params, False)
    del params, state, leaves, step, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compare_digests(model, ranks, ref) -> dict:
    """Each rank's three leaves after the steps against the one-device
    run's slices: sampled values within BF16_TOL of the largest (``compare``)
    and the sum of squares within BF16_TOL relative; the update (after less
    before) within UPDATE_L2_TOL relative L2 and the same sign on at least
    UPDATE_SIGN_MIN of the sampled values either moves."""
    import chip_smoke as cs

    out = {}
    for r in ranks:
        got = r["runs"]["headroom"]
        for k, d in got["digest"].items():
            want = ref["digest"][r["rank"]][k]
            sample = lambda dg: torch.from_numpy(dg["sample"])
            res = cs.compare(f"ep train {model} rank {r['rank']} {k}", sample(d), sample(want),
                             cs.BF16_TOL)
            res["sumsq_rel"] = abs(d["sumsq"] - want["sumsq"]) / max(want["sumsq"], 1e-30)
            if res["sumsq_rel"] > cs.BF16_TOL:
                raise AssertionError(f"ep train {model} rank {r['rank']} {k}: sum of squares "
                                     f"{d['sumsq']} vs one device {want['sumsq']}")
            du = sample(d) - sample(got["digest_before"][k])
            dw = sample(want) - sample(ref["digest_before"][r["rank"]][k])
            res["update_rel_l2"] = float((du - dw).norm() / max(float(dw.norm()), 1e-30))
            moved = (dw != 0) | (du != 0)
            res["update_sign_agree"] = float((torch.sign(du) == torch.sign(dw))[moved].float().mean()) \
                if moved.any() else None
            res["moved"] = int(moved.sum())
            if not res["moved"] or res["update_rel_l2"] > UPDATE_L2_TOL or \
                    res["update_sign_agree"] < UPDATE_SIGN_MIN:
                raise AssertionError(f"ep train {model} rank {r['rank']} {k}: update against one "
                                     f"device's {res}")
            out[f"rank{r['rank']}/{k}"] = res
    return out


def run_model(model: str, counters, lines: list) -> tuple:
    """(a) or (b): the one-device reference, then the ranks; returns
    (summary, launches by path of rank 0)."""
    import chip_smoke as cs
    from repro_torch.serving import ep

    shape, names = MODELS[model][:2]
    batch, seq, steps = MODELS[model][3:6]
    world = 1
    for n in shape:
        world *= n
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = one_device(model, counters)
    lines.append(f"ep train {model}: one-device reference of {batch} x {seq} tokens at each "
                 f"layer's capacity factor E / K in "
                 f"{time.perf_counter() - t0:.1f} s: losses {[r['loss'] for r in ref['rows']]}, "
                 f"grad norms {[r['grad_norm'] for r in ref['rows']]}, dropped share "
                 f"{ref['dropped_share']}, peak {ref['peak_memory'] / 1e9:.2f} GB, "
                 f"{ref['param_count']} parameters, launches {ref['launches']}")
    if ref["dropped_share"]:
        raise AssertionError(f"ep train {model}: E / K dropped on one device")
    nccl = torch.cuda.device_count() >= world
    backend = "nccl" if nccl else "gloo"
    transport = (f"NCCL, one GPU per rank" if nccl else
                 f"gloo, {world} processes time-sharing cuda:0, collectives staged through host "
                 "memory: time-shared, not EP speed")
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # for the ranks
    t0 = time.perf_counter()
    try:
        ranks = ep.launch(rank_body, world, backend=backend, args=(model,), timeout_s=900,
                          threads=max(1, (os.cpu_count() or 1) // world))
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    lines.append(f"ep train {model}: {world} ranks on mesh {shape} over {names} ({transport}) in "
                 f"{time.perf_counter() - t0:.1f} s")
    summary = {"mesh": list(shape), "axes": list(names), "transport": transport,
               "one_device": {k: v for k, v in ref.items() if not k.startswith("digest")},
               "ranks": []}
    by_path = {}
    for run in RUNS:
        losses = [[row["loss"] for row in r["runs"][run]["rows"]] for r in ranks]
        norms = [[row["grad_norm"] for row in r["runs"][run]["rows"]] for r in ranks]
        if any(lz != losses[0] for lz in losses):
            raise AssertionError(f"ep train {model} {run}: the ranks' losses differ: {losses}")
        if not all(math.isfinite(v) for v in losses[0] + norms[0]):
            raise AssertionError(f"ep train {model} {run}: {losses[0]} {norms[0]}")
        launches = [r["runs"][run]["launches"] for r in ranks]
        if any(lz != launches[0] for lz in launches):
            raise AssertionError(f"ep train {model} {run}: the ranks' launches differ: {launches}")
        # the one-device run takes the headroom run's steps; launches are
        # the same every step
        want = {k: v * run_steps(model, run) // steps for k, v in ref["launches"].items()}
        if launches[0] != want:
            raise AssertionError(f"ep train {model} {run}: launches {launches[0]} per rank, one "
                                 f"device {want}")
        by_path[f"ep_train_{model}_{run}"] = launches[0]
        drops = [r["runs"][run]["dropped_share"] for r in ranks]
        entry = {"cf": ranks[0]["runs"][run]["cf"], "tokens": ranks[0]["runs"][run]["tokens"],
                 "losses": losses[0], "grad_norms": norms[0],
                 "launches_per_rank": launches[0], "dropped_share_per_rank": drops,
                 "step_ms_per_rank": [r["runs"][run]["ms"] for r in ranks]}
        if run == "headroom":
            if any(drops):
                raise AssertionError(f"ep train {model}: the headroom factor dropped {drops}")
            ref_l = [row["loss"] for row in ref["rows"]]
            ref_n = [row["grad_norm"] for row in ref["rows"]]
            entry["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses[0], ref_l))
            entry["grad_norm_rel"] = max(abs(a - b) / abs(b) for a, b in zip(norms[0], ref_n))
            if entry["loss_rel"] > cs.BF16_TOL or entry["grad_norm_rel"] > cs.BF16_TOL:
                raise AssertionError(f"ep train {model}: losses {losses[0]} / grad norms {norms[0]} "
                                     f"against one device {ref_l} / {ref_n}")
            entry["digests"] = compare_digests(model, ranks, ref)
        summary[run] = entry
        lines.append(f"ep train {model} {run} ({entry['tokens'][0]} x {entry['tokens'][1]} tokens, "
                     f"capacity factor {entry['cf']}): losses {losses[0]}, "
                     f"grad norms {norms[0]} on every rank" +
                     (f" (one device: within {entry['loss_rel']:.3e} / {entry['grad_norm_rel']:.3e}"
                      " relative)" if run == "headroom" else "") +
                     f"; dropped share per rank {drops}; launches per rank {launches[0]}; step ms "
                     f"rank 0 {[round(v, 1) for v in ranks[0]['runs'][run]['ms']]} ("
                     f"{'not EP speed: time-shared' if not nccl else 'one GPU a rank'})")
        if run == "headroom":
            lines.append(f"ep train {model} leaf digests after step {steps} against one device: "
                         + json.dumps(entry["digests"]))
    for r in ranks:
        h = r["runs"]["headroom"]
        row = {"rank": r["rank"], "device": r["device"], "param_bytes": h["param_bytes"],
               "moment_bytes": h["moment_bytes"], "peak_memory": h["peak_memory"],
               "peak_memory_published": r["runs"]["published"]["peak_memory"],
               "staged_bytes_per_run": {run: r["runs"][run]["staged_bytes"] for run in r["runs"]},
               "staged_total": r["staged_total"], "draw_s": h["draw_s"]}
        summary["ranks"].append(row)
        lines.append(f"ep train {model} rank {r['rank']}: {h['param_bytes'] / 1e9:.2f} GB of "
                     f"parameters, {h['moment_bytes'] / 1e9:.2f} GB of moments, peak "
                     f"{h['peak_memory'] / 1e9:.2f} GB (published run "
                     f"{row['peak_memory_published'] / 1e9:.2f}); staged "
                     f"{h['staged_bytes'] / 1e9:.2f} GB in {h['staged_calls']} collectives at "
                     "headroom")
    # (c) card vs CPU, reduced f32
    if "cpu" not in ranks[0]["reduced"]:
        cpu = ep.launch(reduced_runs, world, backend="gloo", args=(model, ("cpu",)), timeout_s=600)
        for r, c in zip(ranks, cpu):
            r["reduced"]["cpu"] = c["cpu"]
    worst_loss, worst_leaf = 0.0, 0.0
    for r in ranks:
        (lc, pc), (lp, pp) = r["reduced"]["card"], r["reduced"]["cpu"]
        worst_loss = max(worst_loss, max(abs(a - b) / abs(b) for a, b in zip(lc, lp)))
        worst_leaf = max(worst_leaf, max(float(abs(pc[k] - v).max()) for k, v in pp.items()))
    if worst_loss > 1e-5 or worst_leaf > cs.REF_PARAM_TOL:
        raise AssertionError(f"ep train {model} reduced f32 card vs CPU: losses within "
                             f"{worst_loss:.3e}, leaves {worst_leaf:.3e}")
    summary["reduced_card_vs_cpu"] = {"loss_rel": worst_loss, "leaf_abs": worst_leaf,
                                      "losses": ranks[0]["reduced"]["card"][0]}
    lines.append(f"ep train {model} reduced f32 under EP, card vs CPU in the same ranks, "
                 f"{world} ranks: losses {ranks[0]['reduced']['card'][0]} within {worst_loss:.3e} "
                 f"relative, every leaf after {cs.REF_STEPS} steps within {worst_leaf:.3e} "
                 f"(tolerance {cs.REF_PARAM_TOL:g})")
    if model == "llama4":
        summary["checks"] = {f"rank{r['rank']}": r["checks"] for r in ranks}
        for r in ranks:
            lines.append(f"ep train kernels rank {r['rank']}: " + json.dumps(
                {k: {kk: v[kk] for kk in ("max_abs_err", "max_rel_err", "max_row_rel_err")
                     if kk in v} for k, v in r["checks"].items()}))
    return summary, by_path


def ep_train_phase(counters) -> tuple:
    """Phase 19, printing its lines as they come.  Returns (lines, summary,
    launches by path of rank 0)."""
    lines, summary, by_path = Lines(), {}, {}
    t0 = time.perf_counter()
    for model in MODELS:
        s, p = run_model(model, counters, lines)
        summary[model] = s
        by_path.update(p)
    summary["wall_s"] = time.perf_counter() - t0
    lines.append(f"ep train phase time: {summary['wall_s']:.1f} s")
    return lines, summary, by_path


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("ep_train_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build

    counters = cs.kernel_setup()
    build.build(SOURCES)
    _, summary, by_path = ep_train_phase(counters)
    cs.log(json.dumps({"ep_train": summary, "launches_by_path": by_path,
                       "card": cs.nvidia_smi_line()}, default=str))
    return 0


if __name__ == "__main__":
    # the ranks unpickle their body by this module's importable name
    import ep_train_phase

    sys.exit(ep_train_phase.main())
