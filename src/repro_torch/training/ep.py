"""Expert-parallel training on ``torch.distributed``, one process per rank
(ROADMAP item 7b; ``serving/ep.py::launch`` starts the ranks, with its group
timeout and deadline).

``train_rank`` is a rank's whole run: the mesh over the default process
group (``build_train_mesh``: the ``default`` rules, or ``ep_pod`` with the
two-hop exchange), the parameters drawn from the seed and placed
(``draw_placed``: the routed experts cut to this rank's experts and d_ff
slice, the rest replicated), this rank's rows of the synthetic stream, and
``train_loop`` under the mesh (``moe_impl="ep"``: ``core/moe_parallel.py``;
ZeRO-1 AdamW).  JAX's ``launch/train.py`` has no mesh flag, so the port's
CLI has none either: callers launch ``train_rank``.
"""
from __future__ import annotations

import gc
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import data_stream
from repro_torch.models.model import init_params, param_leaves
from repro_torch.parallel.params import batch_axes, shard_params, zero_partition
from repro_torch.quant.ptq import tree_bytes
from repro_torch.parallel.sharding import RULESETS, make_ep_mesh
from repro_torch.training.trainer import TrainConfig, train_loop


def build_train_mesh(shape: Sequence[int], axis_names: Sequence[str], ruleset: str = "default"):
    """(mesh, rules) over the default process group; under ``ep_pod`` the
    layer takes the two-hop exchange (``core/moe_parallel.ep_layout``)."""
    return make_ep_mesh(tuple(shape), tuple(axis_names)), RULESETS[ruleset]


def train_moe_impl(cfg):
    """``cfg`` with its capacity dispatch (``dense``, ``einsum``, ``ep``) as
    the EP layer ``ep``; JAX trains no grouped dispatch under a mesh."""
    if cfg.moe_impl not in ("dense", "einsum", "ep"):
        raise ValueError(f"expert-parallel training runs moe_impl='ep', not {cfg.moe_impl!r}")
    return cfg.replace(moe_impl="ep")


def draw_placed(cfg, mesh, rules, seed: int, device):
    """The tree of ``init_params(cfg, seed)`` placed for training on this
    rank.  The ranks draw one after another (a barrier between), so ranks
    that share a card hold one full tree at a time."""
    params = None
    for r in range(mesh.size):
        if r == mesh.rank:
            full = init_params(cfg, seed=seed, device=device)
            params = shard_params(mesh, rules, full, cfg, mode="train")
            del full
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    return params


def train_rank(rank: int, cfg, shape: Sequence[int], axis_names: Sequence[str], tc: TrainConfig,
               steps: int, batch: int, seq: int, *, ruleset: str = "default", seed: int = 0,
               device="cuda", log_fn=None, params=None) -> dict:
    """One rank's run: ``steps`` AdamW steps of the global ``batch`` x
    ``seq`` stream under the mesh, from ``params`` (a full tree, placed
    here) or the seed's.  Returns the history, the placed tree, the AdamW
    state and each leaf's ZeRO-1 partition, and the parameter and moment
    bytes this rank holds."""
    cfg = train_moe_impl(cfg)
    mesh, rules = build_train_mesh(shape, axis_names, ruleset)
    dp = mesh.axes_size(batch_axes(mesh, rules))
    if batch % dp:
        raise ValueError(f"a global batch of {batch} rows does not split over the {dp} batch "
                         "ranks: each rank's share of the loss assumes equal parts")
    if params is None:
        params = draw_placed(cfg, mesh, rules, seed, device)
    else:
        params = shard_params(mesh, rules, params, cfg, mode="train")
    data = data_stream(cfg.vocab_size, batch, seq, seed=seed, device=device, mesh=mesh,
                       rules=rules)
    params, state, history = train_loop(cfg, tc, data, steps, params=params, log_every=1,
                                        log_fn=log_fn or (lambda *_: None), device=device,
                                        mesh=mesh, rules=rules)
    parts = zero_partition(mesh, rules, param_leaves(params), cfg)
    return {"rank": rank, "history": history, "params": params, "state": state,
            "params_parts": parts, "param_bytes": tree_bytes(params),
            "moment_bytes": tree_bytes(state.m) + tree_bytes(state.v)}
