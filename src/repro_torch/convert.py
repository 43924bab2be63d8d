"""Weights carried across from the JAX package, without importing it.

* ``params_from_numpy``: a JAX parameter tree handed over as nested dicts of
  numpy arrays (``segments/seg{i}/pos{j}/...``, each segment leaf with its
  leading ``[repeats]`` axis) -> the port's :class:`ParamTree`.
* ``load_checkpoint``: a directory written by the JAX package's checkpoint
  ``save`` (``manifest.json`` plus one ``.npy`` per leaf, keyed by tree path)
  -> the same.

Both copy every array (a numpy view of a JAX array is read-only) and check
the tree against the shapes ``init_params`` gives the config.

Both take a tree that the JAX package quantized (``quantize_params``): a
quantized leaf arrives as ``{"q", "scale"}`` (manifest keys ``.../wi/q``,
``.../wi/scale``).  The manifest holds no quantization metadata, so the
caller passes the ``QuantConfig`` it was made with; which leaves it
quantized, and their bits, group size and axis, follow from that config
through the same policy table as ``quantize_params``.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.models import rglru, ssm
from repro_torch.models.model import ParamTree, init_params
from repro_torch.models.modules import DTYPES
from repro_torch.quant.ptq import leaf_quant_args
from repro_torch.quant.qarrays import QuantizedArray


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


def _quantized_like(like: dict, qcfg: Optional[QuantConfig]) -> Tuple[dict, dict]:
    """The flat shapes of the tree ``quantize_params`` makes from a tree of
    shapes ``like``, and the quantize arguments of each quantized leaf."""
    if qcfg is None:
        return {k: tuple(v.shape) for k, v in like.items()}, {}
    shapes, quant = {}, {}
    for key, ref in like.items():
        kw = leaf_quant_args(key.split("/"), qcfg)
        shape = tuple(ref.shape)
        if kw is None:
            shapes[key] = shape
            continue
        axes = [a % len(shape) for a in kw["reduce_axes"]]
        q = list(shape)
        if kw["bits"] == 4:
            q[axes[0]] //= 2  # two nibbles per byte along the first contraction axis
        sc = [1 if i in axes else n for i, n in enumerate(shape)]
        if kw["group_size"]:
            sc[axes[0]] = shape[axes[0]] // kw["group_size"]
        shapes[f"{key}/q"], shapes[f"{key}/scale"] = tuple(q), tuple(sc)
        quant[key] = kw
    return shapes, quant


def _checked(cfg: ModelConfig, flat: dict, where: str, qcfg: Optional[QuantConfig] = None) -> dict:
    """Check the flat tree against ``init_params`` (quantized per ``qcfg``);
    returns the quantize arguments of the quantized leaves."""
    like, quant = _quantized_like(dict(_flatten(init_params(cfg, device="meta"))), qcfg)
    missing = sorted(set(like) - set(flat))
    extra = sorted(set(flat) - set(like))
    if missing or extra:
        raise ValueError(f"{where}: tree does not match {cfg.name} (missing {missing[:5]}, "
                         f"unexpected {extra[:5]})")
    for key, ref in like.items():
        if tuple(flat[key].shape) != ref:
            raise ValueError(f"{where}: leaf {key!r} has shape {tuple(flat[key].shape)}, "
                             f"expected {ref}")
    return quant


# leaves kept in their own type (f32) when a tree is cast: the routers, and
# the SSD and RG-LRU leaves the JAX package keeps in f32 at any width
_OWN_TYPE_LEAVES = ("router",) + ssm.F32_LEAVES + rglru.F32_LEAVES


def _build(cfg: ModelConfig, flat: dict, quant: dict, device, dtype) -> ParamTree:
    """Flat numpy leaves -> ParamTree; each quantized leaf's q/scale pair
    becomes a ``QuantizedArray`` of the original type ``dtype`` (None: the
    config's parameter type)."""
    out = {}
    for key, arr in flat.items():
        parent, _, name = key.rpartition("/")
        kw = quant.get(parent)
        if kw is None:
            t = _to_tensor(arr, device)
            out[key] = t if (dtype is None or name in _OWN_TYPE_LEAVES) else t.to(dtype)
        elif name == "q":
            q, scale = _to_tensor(arr, device), _to_tensor(flat[f"{parent}/scale"], device)
            out[parent] = QuantizedArray(q, scale, kw["bits"], kw["group_size"],
                                         kw["reduce_axes"][0], dtype or DTYPES[cfg.param_dtype])
    return ParamTree(_unflatten(out))


def params_from_numpy(cfg: ModelConfig, tree: dict, device, dtype=None,
                      qcfg: Optional[QuantConfig] = None) -> ParamTree:
    """JAX parameter tree (nested dicts of numpy arrays) -> ParamTree on
    ``device``.  ``dtype`` casts every leaf but the routers and the SSD /
    RG-LRU f32 leaves (``dt_bias``, ``A_log``, ``D``, ``Lambda``), which stay
    f32 as in the JAX package; None keeps each leaf's own type.  ``qcfg``: the
    tree was quantized with it (quantized leaves as ``{"q", "scale"}``)."""
    flat = {k: np.asarray(v) for k, v in _flatten(tree)}
    quant = _checked(cfg, flat, "params_from_numpy", qcfg)
    return _build(cfg, flat, quant, device, dtype)


def load_checkpoint(path: str, cfg: ModelConfig, device,
                    qcfg: Optional[QuantConfig] = None) -> ParamTree:
    """Read a checkpoint directory of the JAX package's format; ``qcfg``: it
    was saved from a tree quantized with that config."""
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
    quant = _checked(cfg, flat, f"checkpoint {path!r}", qcfg)
    return _build(cfg, flat, quant, device, None)


def params_to_numpy(params, bf16=None) -> dict:
    """ParamTree (or nested dicts of tensors) -> nested dicts of numpy arrays
    on the host, the JAX package's tree (``jax.tree.map(jnp.asarray, ...)``
    takes it).  A bf16 leaf becomes 2-byte records (``|V2``), or, given a
    numpy bfloat16 type as ``bf16`` (``ml_dtypes.bfloat16``), an array of
    it; the bits are the tensor's."""
    out = {}
    for key, t in params.items():
        if torch.is_tensor(t):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                a = t.view(torch.int16).cpu().numpy().view(bf16 or np.dtype("V2"))
            else:
                a = t.cpu().numpy().copy()
            out[key] = a
        elif isinstance(t, (dict, ParamTree)):
            out[key] = params_to_numpy(t, bf16)
        else:
            raise TypeError(f"params_to_numpy: leaf {key!r} is a {type(t).__name__} (quantized "
                            "trees are exchanged through quantize_params on each side)")
    return out
