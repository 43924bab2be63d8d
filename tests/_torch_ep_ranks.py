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

