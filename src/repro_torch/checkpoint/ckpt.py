"""Checkpoints in the JAX package's format (``repro/checkpoint/ckpt.py``):
a directory of one ``.npy`` per leaf plus ``manifest.json``, keyed by tree
path (``segments/seg0/pos1/moe/wi``), leaves in the JAX tree's order (keys
sorted at every level), streamed to disk one at a time.

``save`` writes the same manifest, the same file names and the same bytes
as JAX's ``save`` of the same weights.  A bf16 leaf goes out as the 2-byte
records JAX's files hold (numpy header ``'<V2'``, the ``ml_dtypes``
bfloat16's), written here from the tensor's bits, since the card's machine
has no ``ml_dtypes``.  ``load`` restores into the structure of a ``like``
tree, shape-checked, each leaf in ``like``'s type; checkpoints of either
package load into either (``convert.load_checkpoint`` builds a ParamTree
from the config alone).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.convert import _to_tensor
from repro_torch.models.model import ParamTree, param_leaves

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
BF16_DESCR = "<V2"  # what numpy writes for an ml_dtypes bfloat16 array


def _write_npy(fname: str, t: torch.Tensor) -> str:
    """One leaf to ``fname`` as ``np.save`` writes it; returns the dtype name
    the manifest records."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        bits = np.ascontiguousarray(t.view(torch.int16).cpu().numpy()).astype("<u2", copy=False)
        with open(fname, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": BF16_DESCR, "fortran_order": False, "shape": bits.shape})
            f.write(bits.tobytes())
        return "bfloat16"
    arr = t.cpu().numpy()
    np.save(fname, arr)
    return str(arr.dtype)


def save(path: str, tree: Any, *, step: int = 0, extra: dict | None = None) -> int:
    """Write ``tree`` (a ParamTree, or nested dicts of tensors) to the
    directory ``path``; returns the bytes of the leaf files."""
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    written = 0
    for i, (key, leaf) in enumerate(param_leaves(tree).items()):
        fname = f"leaf{i:05d}_{_SAFE.sub('-', key)[:80]}.npy"
        full = os.path.join(path, fname)
        dtype = _write_npy(full, leaf)
        written += os.path.getsize(full)
        manifest["leaves"].append({"key": key, "file": fname, "dtype": dtype,
                                   "shape": list(leaf.shape)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return written


def load(path: str, like: Any, device=None) -> tuple:
    """Restore into the structure of ``like`` (shape-checked, each leaf cast
    to ``like``'s type, on ``device`` or ``like``'s device): returns (tree,
    step), the tree a ParamTree if ``like`` is one, else nested dicts.
    Raises ``ValueError`` when the manifest and ``like`` disagree."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise ValueError(f"no checkpoint at {path!r}: missing manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    flat = param_leaves(like)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    missing = [key for key in flat if key not in by_key]
    if missing:
        raise ValueError(f"checkpoint {path!r} is missing {len(missing)} leaves required by the "
                         f"target structure (first few: {missing[:5]}); was it saved from a "
                         "different architecture or quantization state?")
    unused = set(by_key) - set(flat)
    if unused:
        raise ValueError(f"checkpoint {path!r} holds {len(unused)} leaves the target structure "
                         f"does not expect (first few: {sorted(unused)[:5]}); refusing a "
                         "partial restore.")
    out = {}
    for key, leaf in flat.items():
        arr = np.load(os.path.join(path, by_key[key]["file"]), mmap_mode="r", allow_pickle=False)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r}: stored shape {tuple(arr.shape)} != "
                             f"expected {tuple(leaf.shape)}")
        out[key] = _to_tensor(arr, device or leaf.device, leaf.dtype)
    tree = {}
    for key, t in out.items():
        node = tree
        *parents, name = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t
    return (ParamTree(tree) if isinstance(like, ParamTree) else tree), manifest["step"]
