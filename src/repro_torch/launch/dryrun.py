"""Dry run: what every (architecture × input shape) needs on one H100 and on
expert-parallel meshes of 4 and 8 ranks with one GPU each, on the meta
device (``repro/launch/dryrun.py`` lowers and compiles on TPU meshes; the
port builds the same trees on ``device="meta"``, so nothing is allocated).

Per rank it reports the bytes of the parameters, the gradients (train: the
accumulator of the train entry, ``opt_dtype_for``'s dtype), AdamW's moments
(f32, as the trainer allocates them; ZeRO-1's slices under a mesh), the caches (prefill / decode: the
contiguous caches of the global batch at the shape's length, a rank's
slots of them under a mesh) and the
inputs; whether their sum fits the card's 80 GB (80e9 bytes; activations
are not counted: a lower bound); and the roofline terms on the H100
(``launch/roofline.py``): compute from ``model_flops``, memory from the
parameter and cache bytes a step reads once, the collective term from the
all-to-all bytes a rank sends (each MoE layer exchanges its tokens' top-k
rows of d_model twice forward, and twice more backward in training, (P -
1) / P of them leaving the rank; tokens split evenly over the ranks).

Under a mesh this is the port's own layout: experts sharded over the
mesh's ``data`` axis, every other leaf replicated, ZeRO-1 moments
(tensor parallelism and ZeRO-3, ROADMAP item 7d, are not ported), and the
caches of a rank's slots only where the global batch divides over the ranks
(JAX's serving layout, ``serving/ep.py::place_caches``); the output says
so.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama4-maverick-400b-a17b \
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import torch

from repro_torch.configs.base import count_params
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch.roofline import CARD, HBM_BW, NVLINK_BW, PEAK_OPS, model_flops
from repro_torch.launch.steps import input_specs, opt_dtype_for, paper_mesh
from repro_torch.models.model import param_leaves
from repro_torch.models.modules import DTYPES
from repro_torch.quant import kv_cache_bytes, tree_bytes

CARD_BYTES = 80e9
MESHES = (1, 4, 8)
LAYOUT = ("experts sharded over the mesh's data axis, every other leaf replicated, ZeRO-1 "
          "moments, the caches of the rank's slots where the batch divides; tensor "
          "parallelism and ZeRO-3 (ROADMAP 7d) not ported")


def _moe_layers(cfg):
    return [ls.ffn for ls in cfg.layer_specs() if ls.ffn.kind == "moe"]


def a2a_bytes(cfg, shape, ranks: int) -> float:
    """All-to-all bytes a rank sends in one step (the module docstring)."""
    if ranks <= 1:
        return 0.0
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    passes = 4 if shape.kind == "train" else 2
    itemsize = torch.empty((), dtype=DTYPES[cfg.param_dtype]).element_size()
    per = sum(tokens / ranks * f.top_k * cfg.d_model * itemsize * (ranks - 1) / ranks
              for f in _moe_layers(cfg))
    return passes * per


def state_bytes(cfg, shape, ranks: int = 1, *, accumulate: bool = True) -> dict:
    """One rank's bytes by part for ``shape`` (``accumulate``: train
    gradients in the accumulator's dtype; else in the parameters')."""
    mesh = paper_mesh((ranks,)) if ranks > 1 else None
    out = {"params": 0, "grads": 0, "moments": 0, "caches": 0, "inputs": 0}
    specs = input_specs(cfg, shape, mesh)
    args = specs["args"]
    params = args[0]
    out["params"] = tree_bytes(params)
    if shape.kind == "train":
        leaves = param_leaves(params)
        gsize = lambda t: (torch.empty((), dtype=opt_dtype_for(cfg)).element_size()
                           if accumulate else t.element_size())
        out["grads"] = sum(t.numel() * gsize(t) for t in leaves.values())
        out["moments"] = kv_cache_bytes(args[1].m) + kv_cache_bytes(args[1].v)
        out["inputs"] = kv_cache_bytes(args[2])
    else:
        out["caches"] = kv_cache_bytes(args[2] if shape.kind == "prefill" else args[3])
        out["inputs"] = sum(kv_cache_bytes(a) for a in args[1:] if torch.is_tensor(a))
    return out


def dryrun(arch: str, shape_name: str, ranks: int = 1, *, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "single" if ranks == 1 else f"ep{ranks}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ranks": ranks, "card": CARD}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}")
        return {**rec, "status": "skipped", "reason": why}
    if ranks > 1 and not _moe_layers(cfg):
        why = f"{arch}: no MoE layer, nothing to shard over an EP mesh"
        if verbose:
            print(f"[skip] {arch} x {shape_name} ({mesh_name}): {why}")
        return {**rec, "status": "skipped", "reason": why}
    t0 = time.time()
    try:
        parts = state_bytes(cfg, shape, ranks)
        total = sum(parts.values())
        mf = model_flops(cfg, shape)
        t_compute = mf / (ranks * PEAK_OPS["bfloat16"])
        t_memory = (parts["params"] + parts["caches"]) / HBM_BW
        coll = a2a_bytes(cfg, shape, ranks)
        t_coll = coll / NVLINK_BW
        terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
        rec.update(status="ok", bytes=parts, total_bytes=total, fits=total <= CARD_BYTES,
                   params_total=count_params(cfg), model_flops=mf, collective_bytes=coll,
                   t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
                   dominant=max(terms, key=terms.get), seconds=round(time.time() - t0, 3))
        if ranks > 1:
            rec["layout"] = LAYOUT
        if verbose:
            print(f"[ok] {arch} x {shape_name} ({mesh_name}): {total / 1e9:.1f} GB a rank "
                  f"({', '.join(f'{k} {v / 1e9:.1f}' for k, v in parts.items() if v)}), "
                  f"{'fits' if rec['fits'] else 'does not fit'} 80 GB; compute "
                  f"{t_compute * 1e3:.2f} ms memory {t_memory * 1e3:.2f} ms collective "
                  f"{t_coll * 1e3:.2f} ms dominant={rec['dominant']}")
    except Exception as e:  # a pair that fails is an error row, and the exit code says so
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        if verbose:
            print(f"[ERROR] {arch} x {shape_name} ({mesh_name}): {rec['error']}")
    return rec


def run_all(archs=ASSIGNED, shapes=None, meshes=MESHES, verbose: bool = False) -> list:
    shapes = list(SHAPES) if shapes is None else shapes
    return [dryrun(a, s, r, verbose=verbose) for r in meshes for a in archs for s in shapes]


def summary(results) -> str:
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    fits = {m: sum(1 for r in results if r["status"] == "ok" and r["mesh"] == m and r["fits"])
            for m in dict.fromkeys(r["mesh"] for r in results)}
    return (f"dry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors / {len(results)} "
            f"pairs; fit 80 GB a rank: " + ", ".join(f"{m} {n}" for m, n in fits.items()))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[None, *SHAPES])
    ap.add_argument("--all", action="store_true", help="every assigned arch x shape x mesh")
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    results = run_all(archs, shapes, verbose=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(summary(results))
    if any(r["status"] == "error" for r in results):
        for r in results:
            if r["status"] == "error":
                print(f"  FAILED: {r['arch']} x {r['shape']} ({r['mesh']}): {r['error']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
