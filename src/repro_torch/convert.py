"""Weights carried across from the JAX package, without importing it.

* ``params_from_numpy``: a JAX parameter tree handed over as nested dicts of
  numpy arrays (``segments/seg{i}/pos{j}/...``, each segment leaf with its
  leading ``[repeats]`` axis) -> the port's :class:`ParamTree`.
* ``load_checkpoint``: a directory written by the JAX package's checkpoint
  ``save`` (``manifest.json`` plus one ``.npy`` per leaf, keyed by tree path)
  -> the same.

Both copy every array (a numpy view of a JAX array is read-only) and check
the tree against the shapes ``init_params`` gives the config.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import ParamTree, init_params


def _to_tensor(arr, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        # bf16 (ml_dtypes, or raw 2-byte records when read back from .npy
        # without it): reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, (dict, ParamTree)):
            yield from _flatten(v, key + "/")
        else:
            yield key, v


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _checked(cfg: ModelConfig, flat: dict, where: str) -> None:
    like = dict(_flatten(init_params(cfg, device="meta")))
    missing = sorted(set(like) - set(flat))
    extra = sorted(set(flat) - set(like))
    if missing or extra:
        raise ValueError(f"{where}: tree does not match {cfg.name} (missing {missing[:5]}, "
                         f"unexpected {extra[:5]})")
    for key, ref in like.items():
        if tuple(flat[key].shape) != tuple(ref.shape):
            raise ValueError(f"{where}: leaf {key!r} has shape {tuple(flat[key].shape)}, "
                             f"expected {tuple(ref.shape)}")


def params_from_numpy(cfg: ModelConfig, tree: dict, device, dtype=None) -> ParamTree:
    """JAX parameter tree (nested dicts of numpy arrays) -> ParamTree on
    ``device``.  ``dtype`` casts every leaf but the routers, which stay f32
    as in the JAX package; None keeps each leaf's own type."""
    flat = {k: np.asarray(v) for k, v in _flatten(tree)}
    _checked(cfg, flat, "params_from_numpy")
    out = {}
    for key, arr in flat.items():
        t = _to_tensor(arr, device)
        out[key] = t if (dtype is None or key.endswith("/router")) else t.to(dtype)
    return ParamTree(_unflatten(out))


def load_checkpoint(path: str, cfg: ModelConfig, device) -> ParamTree:
    """Read a checkpoint directory of the JAX package's format."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise ValueError(f"no checkpoint at {path!r}: missing manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    flat = {}
    for e in manifest["leaves"]:
        arr = np.load(os.path.join(path, e["file"]), mmap_mode="r", allow_pickle=False)
        if list(arr.shape) != list(e["shape"]):
            raise ValueError(f"checkpoint leaf {e['key']!r}: file shape {arr.shape} != manifest {e['shape']}")
        flat[e["key"]] = arr
    _checked(cfg, flat, f"checkpoint {path!r}")
    return ParamTree(_unflatten({k: _to_tensor(a, device) for k, a in flat.items()}))
