"""Rank bodies of the port's expert-parallel tests (``serving.ep.launch``
runs them in spawned processes, one per rank).  This module imports torch
and the port only, so a rank starts without JAX."""
import torch

from repro_torch.configs.base import FFNSpec
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import make_ep_mesh, use_mesh

MESHES = {"flat4": ((4,), ("data",)), "hier22": ((2, 2), ("pod", "data"))}
RULES = {"flat4": {"expert": "data", "batch": "data"},
         "hier22": {"expert": ("pod", "data"), "batch": ("pod", "data")}}


def meshes():
    """Both meshes of the tests, built in the same order on every rank."""
    return {k: make_ep_mesh(shape, names) for k, (shape, names) in MESHES.items()}


def ffn_spec(case: dict) -> FFNSpec:
    return FFNSpec(kind="moe", d_ff=case["F"], num_experts=case["E"], top_k=case["K"],
                   capacity_factor=case["cf"], act="swiglu")


def collectives_and_layers(rank: int, bufs: dict, routing: dict, layer_cases: dict,
                           params: dict) -> dict:
    """Every collective and layer case of ``test_torch_ep.py`` on this rank:
    ``bufs[mesh]`` [4, E, C, D] (one buffer a rank), ``routing[seed]`` the
    skewed logits [4, T_loc, E], ``layer_cases`` the layer inputs (each
    with its router), ``params`` the experts."""
    from repro_torch.core import moe as tmoe
    from repro_torch.core.dispatch import dispatch_dense
    from repro_torch.core.gating import top_k_gating
    from repro_torch.core.moe_serve import SCHEDULES, schedule_of
    from repro_torch.parallel.params import ep_rank

    out = {}
    ms = meshes()
    for key, mesh in ms.items():
        names = mesh.axis_names
        x = torch.from_numpy(bufs[key][rank])
        flat = col.flat_all_to_all(x, mesh, names)
        out[f"{key}/flat"] = flat.numpy()
        out[f"{key}/flat_back"] = col.flat_all_to_all_back(flat, mesh, names).numpy()
        if len(names) == 2:
            hier = col.hierarchical_all_to_all(x, mesh, names[1], names[0])
            out[f"{key}/hier"] = hier.numpy()
            out[f"{key}/hier_back"] = col.hierarchical_all_to_all_back(
                hier, mesh, names[1], names[0]).numpy()
        out[f"{key}/gather"] = col.all_gather(x[:1], mesh, names).numpy()
        out[f"{key}/psum"] = col.psum(x, mesh, names).numpy()
        out[f"{key}/ep_rank"] = ep_rank(mesh, names)
        # token conservation: each rank dispatches its tokens (id in channel
        # 0, a count of 1 in channel 1) by its own gating, then both exchanges
        for seed, logits in routing.items():
            K, T_loc = 2, logits.shape[1]
            E = logits.shape[2]
            cap = T_loc * K  # every assignment fits: no drops by construction
            g = top_k_gating(torch.from_numpy(logits[rank]), K, cap)
            ids = torch.arange(T_loc, dtype=torch.float32) + 1 + rank * T_loc
            buf = dispatch_dense(torch.stack([ids, torch.ones_like(ids)], -1), g, cap, E)
            out[f"{key}/route{seed}/flat"] = col.flat_all_to_all(buf, mesh, names).numpy()
            if len(names) == 2:
                out[f"{key}/route{seed}/hier"] = col.hierarchical_all_to_all(
                    buf, mesh, names[1], names[0]).numpy()
        # the layer's schedules, and the one-device layer beside them
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        with use_mesh(mesh, RULES[key]):
            for name, case in layer_cases.items():
                spec = ffn_spec(case)
                x = torch.from_numpy(case["x"])
                impl = "ep_grouped" if case["kernel"] == "grouped" else "ep_serve"
                pc = dict(p, router=torch.from_numpy(case["router"]))
                y, aux, stats = tmoe.moe_layer(None, spec, pc, x, impl=impl, with_stats=True)
                out[f"{key}/{name}/y"] = y.numpy()
                out[f"{key}/{name}/aux"] = aux.numpy()
                out[f"{key}/{name}/schedule"] = schedule_of(case["kernel"], x.shape[0] * x.shape[1],
                                                           spec)
                out[f"{key}/{name}/tokens_per_expert"] = stats.tokens_per_expert.numpy()
            # the mapping table refuses a multi-rank mesh
            try:
                case = layer_cases["a2a"]
                tmoe.moe_layer(None, ffn_spec(case), dict(p, router=torch.from_numpy(case["router"])),
                               torch.from_numpy(case["x"]), impl="dense")
                out[f"{key}/dense_refusal"] = ""
            except ValueError as e:
                out[f"{key}/dense_refusal"] = str(e)
        assert set(SCHEDULES) >= {out[f"{key}/{n}/schedule"] for n in layer_cases}
    return out


def serve_engines(rank: int, cases: dict) -> dict:
    """Every engine case of ``test_torch_ep_serving.py`` on this rank, on
    both meshes: greedy tokens, and for the preempting case the pool's state
    after the run."""
    from repro_torch import convert
    from repro_torch.quant.ptq import quantize_params, quantized_leaf_paths
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    out = {}
    params = {}
    for name, case in cases.items():
        p = convert.params_from_numpy(case["cfg"], case["params"], "cpu")
        params[name] = quantize_params(p, case["quant"]) if case.get("quant") else p
    for key, (shape, _) in MESHES.items():
        for name, case in cases.items():
            cfg = case["cfg"].replace(ep_mesh=shape)
            reqs = [Request(p, case["new"]) for p in case["prompts"]]
            if case["engine"] == "static":
                eng = Engine(cfg, params[name], EngineConfig(**case["kw"]), device="cpu")
                out[f"{key}/{name}"] = [r.tokens for r in eng.generate(reqs)]
            else:
                eng = ContinuousEngine(cfg, params[name], device="cpu", **case["kw"])
                ids = [eng.submit(r) for r in reqs]
                done = eng.run_until_done()
                out[f"{key}/{name}"] = [done[i].tokens for i in ids]
                eng.pool.check()
                out[f"{key}/{name}/pool"] = (eng.preemptions, eng.pool.free_count,
                                             eng.pool.used_count, eng.n_pages)
            out[f"{key}/{name}/impl"] = eng.cfg.moe_impl
            out[f"{key}/{name}/quantized"] = quantized_leaf_paths(eng.params)
            out[f"{key}/{name}/experts"] = [tuple(v.shape) for k, v in
                                            eng.params["segments"]["seg0"].named_buffers()
                                            if k.endswith("moe.wi")]
    return out


def raise_on(rank: int, bad: int) -> int:
    """A rank body that fails on rank ``bad`` while the others wait in a
    collective."""
    import torch.distributed as dist

    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def sleep_forever(rank: int) -> None:
    import time

    time.sleep(3600)



# ---------------------------------------------------------------------------
# Expert-parallel training (test_torch_ep_train.py)
# ---------------------------------------------------------------------------

# name -> (shape, axis names, ruleset)
TRAIN_MESHES = {"dm22": ((2, 2), ("data", "model"), "default"),
                "pd22": ((2, 2), ("pod", "data"), "ep_pod"),
                "d4": ((4,), ("data",), "default")}


def train_meshes():
    """The training meshes, built in the same order on every rank."""
    return {k: make_ep_mesh(shape, names) for k, (shape, names, _) in TRAIN_MESHES.items()}


def ep_layer_grads(rank: int, cases: dict, experts: dict, c_aux: float) -> dict:
    """Each layer case of ``test_torch_ep_train.py`` on this rank: the
    rank's rows through ``moe_layer(impl="ep", with_stats=True)`` and the
    gradients of its share of ``sum(y * w) + c_aux * aux`` in its rows, the
    router and its expert slices."""
    from repro_torch.core import moe as tmoe
    from repro_torch.core import moe_parallel as mp
    from repro_torch.data.pipeline import local_rows
    from repro_torch.parallel.sharding import RULESETS

    ms = train_meshes()
    out = {}
    for name, case in cases.items():
        mesh = ms[case["mesh"]]
        ruleset = TRAIN_MESHES[case["mesh"]][2]
        rules = RULESETS[ruleset]
        spec = FFNSpec(kind="moe", d_ff=case["F"], num_experts=case["E"], top_k=case["K"],
                       capacity_factor=case["cf"], act=case["act"])
        rows = local_rows(mesh, rules, case["x"].shape[0])
        full = {k: torch.from_numpy(v) for k, v in experts.items()
                if case["act"] == "swiglu" or k != "wg"}
        wi, wg, wo = mp.local_experts(full, spec, mesh, rules)
        leaves = {"x": torch.from_numpy(case["x"][rows]),
                  "router": torch.from_numpy(case["router"]),
                  "wi": wi.clone(), "wo": wo.clone()}
        if case["act"] == "swiglu":
            leaves["wg"] = wg.clone()
        for t in leaves.values():
            t.requires_grad_(True)
        with use_mesh(mesh, rules):
            p = {k: v for k, v in leaves.items() if k != "x"}
            y, aux, stats = tmoe.moe_layer(None, spec, p, leaves["x"], impl="ep", with_stats=True)
            loss = (y * torch.from_numpy(case["w"][rows])).sum() + c_aux * aux
            grads = torch.autograd.grad(loss, list(leaves.values()))
        axes, _, E_loc, F_loc = mp.ep_layout(spec, mesh, rules)
        from repro_torch.parallel.params import ep_rank

        res = {"y": y.detach().numpy(), "aux": float(aux), "rows": (rows.start, rows.stop),
               "experts": (ep_rank(mesh, axes) * E_loc, E_loc),
               "f": ((mesh.axis_index("model") if "model" in mesh.axis_names else 0) * F_loc, F_loc),
               "tokens_per_expert": stats.tokens_per_expert.numpy(),
               "dropped_frac": float(stats.dropped_frac)}
        res.update({f"d_{k}": g.numpy() for k, g in zip(leaves, grads)})
        out[name] = res
    return out


def ep_train_steps(rank: int, cases: dict, steps: int, batch: int, seq: int, lr: float) -> dict:
    """Each train-step case: ``steps`` AdamW steps of the reduced model on
    its mesh from the given initial tree (``training/ep.py::train_rank``):
    the global losses, this rank's leaves and moments after the last step,
    its ZeRO-1 partition and its bytes."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_config, make_reduced, with_capacity_factor
    from repro_torch.models.model import param_leaves
    from repro_torch.training.ep import train_rank
    from repro_torch.training.trainer import TrainConfig

    train_meshes()
    out = {}
    for name, case in cases.items():
        shape, names, ruleset = TRAIN_MESHES[case["mesh"]]
        cfg = with_capacity_factor(make_reduced(get_config(case["arch"])), case["cf"])
        full = convert.params_from_numpy(cfg.replace(moe_impl="ep"), case["init"], "cpu")
        tc = TrainConfig(lr=lr, warmup_steps=1, decay_steps=10)
        res = train_rank(rank, cfg, shape, names, tc, steps, batch, seq, ruleset=ruleset,
                         device="cpu", params=full)
        parts = res["params_parts"]
        out[name] = {
            "loss": [h["loss"] for h in res["history"]],
            "grad_norm": [h["grad_norm"] for h in res["history"]],
            "params": {k: v.detach().numpy() for k, v in param_leaves(res["params"]).items()},
            "m": {k: v.numpy() for k, v in res["state"].m.items()},
            "v": {k: v.numpy() for k, v in res["state"].v.items()},
            "parts": {k: tuple(p) for k, p in parts.items()},
            "param_bytes": res["param_bytes"], "moment_bytes": res["moment_bytes"]}
    return out


def ep_train_entry(rank: int, arch: str, cf: float, init: dict, batch: dict, steps: int) -> dict:
    """``make_train_entry`` (two microbatches) under (2, 2) ``data`` x
    ``model`` from a full initial tree, every rank given the global batch:
    the losses, this rank's leaves and first moments, its partition."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_config, make_reduced, with_capacity_factor
    from repro_torch.launch.steps import make_train_entry
    from repro_torch.models.model import param_leaves
    from repro_torch.parallel.params import shard_params
    from repro_torch.parallel.sharding import RULESETS
    from repro_torch.training.trainer import init_opt_state

    train_meshes()
    mesh, rules = train_meshes()["dm22"], RULESETS["default"]
    cfg = with_capacity_factor(make_reduced(get_config(arch)), cf).replace(moe_impl="ep")
    params = shard_params(mesh, rules, convert.params_from_numpy(cfg, init, "cpu"), cfg,
                          mode="train")
    step = make_train_entry(cfg, accum_steps=2, mesh=mesh, rules=rules)
    state = init_opt_state(params, step.dist_ctx)
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
          for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, tb)
        losses.append(float(m["loss"]))
    return {"loss": losses, "params": {k: v.detach().numpy() for k, v in param_leaves(params).items()},
            "m": {k: v.numpy() for k, v in state.m.items()},
            "parts": {k: tuple(p) for k, p in step.dist_ctx.parts.items()}}


# ---------------------------------------------------------------------------
# Slot-sharded serving (test_torch_ep_slots.py)
# ---------------------------------------------------------------------------


def cache_arrays(cfg, caches, paged: bool) -> tuple:
    """(per-slot tensors, pool tensors) of a cache tree as numpy, in the
    port's fixed leaf order."""
    from repro_torch.models.model import _layer_entries, _row_tensors, _tensors

    per = [t.numpy().copy() for t in _row_tensors(cfg, caches, paged)]
    pool = []
    if paged:
        for sk, pk, _, pooled in _layer_entries(cfg):
            if pooled:
                pool += [t.numpy().copy() for t in _tensors(caches[sk][pk]["self"])]
    return per, pool


def slot_case(case: dict, shape=None) -> dict:
    """One case of ``test_torch_ep_slots.py`` through its engine, on the mesh
    ``shape`` (None: one device): greedy tokens, the caches' per-slot and
    pool tensors after the trace (the static engine's last batch), the
    rank's rows of the slots and the prefix hits (forks included)."""
    from repro_torch import convert
    from repro_torch.models.model import slot_rows
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    cfg = case["cfg"] if shape is None else case["cfg"].replace(ep_mesh=shape)
    params = convert.params_from_numpy(case["cfg"], case["params"], "cpu")
    reqs = [Request(p, case["new"]) for p in case["prompts"]]
    if case["engine"] == "static":
        eng = Engine(cfg, params, EngineConfig(**case["kw"]), device="cpu")
        made = []
        make = eng._make_caches
        eng._make_caches = lambda b: made.append(make(b)) or made[-1]
        tokens = [r.tokens for r in eng.generate(reqs)]
        caches, paged = made[-1], False
    else:
        eng = ContinuousEngine(cfg, params, device="cpu", **case["kw"])
        if case.get("fork"):
            ids = eng.submit_n(reqs[0], case["fork"]) + [eng.submit(r) for r in reqs[1:]]
        else:
            ids = [eng.submit(r) for r in reqs]
        done = eng.run_until_done()
        tokens = [done[i].tokens for i in ids]
        caches, paged = eng.caches, eng.paged
    rows = slot_rows(caches)
    per, pool = cache_arrays(eng.cfg, caches, paged)
    return dict(tokens=tokens, per=per, pool=pool, hits=getattr(eng, "prefix_hits", 0),
                rows=None if rows is None else (rows.axes, rows.lo, rows.hi))


def slot_engines(rank: int, cases: dict) -> dict:
    """Every case of ``test_torch_ep_slots.py`` on both meshes, on this
    rank."""
    torch.manual_seed(0)
    return {f"{key}/{name}": slot_case(case, shape)
            for key, (shape, _) in MESHES.items() for name, case in cases.items()}
