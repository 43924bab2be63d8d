"""Expert-parallel serving plumbing (``repro/serving/ep.py``; paper §5.2-5.3)
on ``torch.distributed``, one process per rank.

Every rank builds the same engine from the same config and requests and
makes the same host decisions; each holds its own slice of the routed
experts, replicated copies of the other parameters (attention, norms,
embeddings, the router, the shared expert) and of the page pool, and its
block of the slots' caches.  A step runs the embedding, attention, norms,
dense FFNs and logits data-parallel over the slots (each rank on its rows,
where the slots divide over the ``batch`` axes) and the experts
expert-parallel (paper §5.1-5.2; JAX's ``batch`` hints and
``place_caches``).  Rank 0 returns or prints the results.

  * ``build_serving_mesh``: the mesh and sharding rules of ``cfg.ep_mesh``
    over the default process group: ``(n,)`` flat EP over one axis,
    ``(outer, inner)`` the ("pod", ep_axis) mesh, outer-major, whose MoE
    exchange is the hierarchical two-hop all-to-all (Fig. 8).  Experts
    shard over every axis; nothing else does.
  * ``init_engine_mesh``: the mesh, and the config with ``moe_impl``
    rewritten to the serving schedule (core/moe_serve.py): ``grouped`` ->
    ``ep_grouped``, every capacity impl -> ``ep_serve``.
  * ``place_params``: this rank's expert slice kept, the rest of each expert
    leaf freed, every other leaf as it is (parallel/params.py);
    ``place_caches``: each per-slot cache leaf cut to this rank's rows, the
    pools replicated (``SlotCaches``); ``slot_shard``: the rows a batch of
    slots shards into; ``gather_rows`` / ``gather_sampled``: every slot's
    rows or sampled tokens on every rank; ``placed_param_bytes``: this rank's parameter bytes.
  * ``launch``: runs a function on every rank in spawned processes with a
    default process group, a timeout on every group and a deadline on the
    whole run; the CLI and the tests share it.

The engines enter ``use_mesh`` around their model calls (``mesh_scope``);
the port compiles nothing, so JAX's ``MeshCall`` has no counterpart.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives as col
from repro_torch.parallel.params import cache_pspecs, shard_params
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    GROUP_TIMEOUT,
    EpMesh,
    RowShard,
    batch_shard,
    make_ep_mesh,
    use_mesh,
)

# where ``launch`` makes its rendezvous files unless told otherwise: beside
# the kernels' build directory, inside the checkout
RENDEZVOUS_DIR = Path(__file__).resolve().parents[3] / "build" / "ep"


def parse_ep_mesh(text: str) -> Tuple[int, ...]:
    """'4' -> (4,); '2x2' -> (2, 2) (outer x inner)."""
    try:
        shape = tuple(int(p) for p in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad --ep-devices {text!r}: expected '8' or '4x2'") from None
    if not shape or any(n < 1 for n in shape) or len(shape) > 2:
        raise ValueError(f"bad --ep-devices {text!r}: expected '8' or '4x2'")
    return shape


def mesh_size(shape) -> int:
    n = 1
    for s in shape or ():
        n *= int(s)
    return n


def build_serving_mesh(shape, *, ep_axis: str = "data", timeout=GROUP_TIMEOUT):
    """(mesh, rules) for an EP serving topology over the default process
    group, or (None, None) when the shape is trivial.  1-d: flat EP over
    ``ep_axis``; 2-d: ("pod", ep_axis), outer axis major, experts over
    both.  Raises when no default group is initialized or its world size is
    not the mesh's size."""
    shape = tuple(int(n) for n in (shape or ()))
    if not shape or mesh_size(shape) <= 1:
        return None, None
    if len(shape) == 1:
        names: Tuple[str, ...] = (ep_axis,)
        expert = ep_axis
    elif len(shape) == 2:
        names = ("pod", ep_axis)
        expert = names
    else:
        raise ValueError(f"ep_mesh supports 1 or 2 axes, got {shape}")
    mesh = make_ep_mesh(shape, names, timeout=timeout)
    return mesh, {**DEFAULT_RULES, "expert": expert, "batch": expert}


def serving_moe_impl(impl: str) -> str:
    """A one-device ``moe_impl`` -> its EP serving schedule."""
    if impl in ("ep_serve", "ep_grouped"):
        return impl
    return "ep_grouped" if impl == "grouped" else "ep_serve"


def init_engine_mesh(cfg):
    """(mesh, rules, cfg'): None / None / cfg when ``cfg.ep_mesh`` is
    trivial, else the serving mesh and cfg with ``moe_impl`` rewritten to
    the EP schedule."""
    mesh, rules = build_serving_mesh(getattr(cfg, "ep_mesh", ()),
                                     ep_axis=getattr(cfg, "ep_axis", "data"))
    if mesh is None:
        return None, None, cfg
    return mesh, rules, cfg.replace(moe_impl=serving_moe_impl(cfg.moe_impl))


def ep_degree(mesh: Optional[EpMesh]) -> int:
    return 1 if mesh is None else mesh.size


def mesh_scope(mesh: Optional[EpMesh], rules: Optional[dict]):
    """``use_mesh(mesh, rules)``, or no change to the ambient mesh when
    ``mesh`` is None (a one-device engine)."""
    return use_mesh(mesh, rules) if mesh is not None else contextlib.nullcontext()


def place_params(mesh: EpMesh, rules: dict, params, cfg=None):
    """This rank's tree: the routed experts' leaves cut to its slice (copies:
    the full leaves are freed with the caller's tree), every other leaf the
    caller's tensor.  Given the model's ``cfg``, a tree placed before on the
    same expert axes passes as it is."""
    return shard_params(mesh, rules, params, cfg)


def slot_shard(mesh: Optional[EpMesh], rules: Optional[dict], slots: int,
               n_pages: Optional[int] = None) -> Optional[RowShard]:
    """This rank's rows of ``slots`` cache rows, or None where every rank
    holds every row: no mesh, slots that no ``batch`` axis divides, or JAX's
    degenerate case ``n_pages + 1 == slots`` (its shape test cannot tell a
    pool from a per-slot leaf there, so it replicates everything)."""
    if mesh is None or (n_pages is not None and n_pages + 1 == slots):
        return None
    return batch_shard(slots, mesh, rules)


def place_caches(mesh: EpMesh, rules: dict, caches, *, slots: int, n_pages: Optional[int] = None):
    """This rank's caches (``SlotCaches``): each per-slot leaf ``[repeats,
    slots, ...]`` cut to the rank's rows (copies, so the full leaves are
    freed with the caller's tree), the paged pools replicated (each rank
    reads only its slots' pages, and every rank writes every row's K/V into
    its copy).  Where ``slot_shard`` gives None every leaf stays whole and
    every rank runs every slot."""
    from repro_torch.models.model import SlotCaches, _map_tensors
    from repro_torch.quant.kv import QuantizedKV

    rows = slot_shard(mesh, rules, slots, n_pages)
    if rows is None:
        return SlotCaches(caches, None)
    specs = cache_pspecs(mesh, rules, caches, slots)

    def place(node, spec):
        if isinstance(node, dict):
            return {k: place(v, spec[k]) for k, v in node.items()}
        if (spec.q if isinstance(spec, QuantizedKV) else spec) is None:
            return node
        return _map_tensors(node, lambda t: rows.take(t, 1).clone())

    return SlotCaches(place(caches, specs), rows)


def gather_rows(x, n: int):
    """Every row of a step over ``n`` rows on every rank, from this rank's
    rows ``x`` (the ambient mesh's ``batch_shard(n)``); ``x`` itself where
    it holds all n."""
    rows = batch_shard(n) if x.shape[0] != n else None
    return x if rows is None else col.all_gather(x, rows.mesh, rows.axes)


def gather_sampled(logits, n: int, sample_fn, greedy: bool):
    """Every row's sampled token ([n] int32) on every rank from this rank's
    rows of a step's logits: greedy tokens are sampled on the rows and
    gathered; otherwise the logits are gathered and sampled whole, so each
    rank's generator draws what one device's draws."""
    if greedy:
        return gather_rows(sample_fn(logits), n)
    return sample_fn(gather_rows(logits, n))


def placed_param_bytes(params) -> int:
    """This rank's parameter bytes (a quantized leaf: its integers and
    scales)."""
    from repro_torch.quant.ptq import tree_bytes

    return tree_bytes(params)


# ---------------------------------------------------------------------------
# Rank launcher
# ---------------------------------------------------------------------------


def _rank_entry(fn, rank: int, world: int, backend: str, store: str, timeout_s: float,
                threads: int, args: tuple, results) -> None:
    try:
        torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # noqa: BLE001  (the parent re-raises it with the rank)
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world: int, *, backend: str, args: Sequence = (),
           timeout_s: float = 600.0, threads: int = 1, rendezvous_dir=None) -> list:
    """``fn(rank, *args)`` on ranks ``0 .. world - 1``, each in a process of
    its own (the spawn start method; ``fn`` and ``args`` must pickle, ``fn``
    importable by name), in a default process group of ``backend``
    (``gloo``: CPU or staged CUDA tensors; ``nccl``: one visible GPU per
    rank, rank r on ``cuda:r``).  Returns the ranks' results in rank order.

    Every group waits at most ``timeout_s`` in a collective, and the run as
    a whole ends by then too: a rank that fails, exits or outlasts the
    deadline ends every rank, and this raises with its traceback."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} visible GPUs, one each; "
                           f"{torch.cuda.device_count()} visible")
    base = Path(rendezvous_dir) if rendezvous_dir is not None else RENDEZVOUS_DIR
    base.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rdv-", dir=base)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world, backend, os.path.join(tmp, "store"), timeout_s,
                               threads, tuple(args), results))
             for r in range(world)]
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before returning")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                       f"finish within {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
