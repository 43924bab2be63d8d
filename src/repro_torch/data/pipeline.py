"""Batches on a device (``repro/data/pipeline.py``): the synthetic stream's
numpy (tokens, labels) as int64 tensors on an explicit device.

Under an ambient mesh (expert-parallel training, one process per rank) a
rank takes its rows of the global batch: those that JAX's
``make_array_from_callback`` over ``named_sharding("batch", "seq")`` gives
the device at the rank's mesh coordinates.  The rows split over the
``batch`` rule's axes that are in the mesh and divide the batch (JAX's
``_filter_axes``), outer-major; ranks that differ only along other axes
(``model``) take the same rows."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import batches
from repro_torch.parallel.sharding import EpMesh, batch_shard, get_mesh, get_rules


def local_rows(mesh: EpMesh, rules: dict, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows."""
    shard = batch_shard(batch, mesh, rules)
    return slice(0, batch) if shard is None else slice(shard.lo, shard.hi)


def device_put_batch(tokens: np.ndarray, labels: np.ndarray, device,
                     mesh: Optional[EpMesh] = None,
                     rules: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels) on ``device``; under ``mesh`` (default: the ambient
    one) this rank's rows only."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is not None:
        rows = local_rows(mesh, rules if rules is not None else get_rules(), tokens.shape[0])
        tokens, labels = tokens[rows], labels[rows]
    return (torch.from_numpy(np.asarray(tokens, np.int64)).to(device),
            torch.from_numpy(np.asarray(labels, np.int64)).to(device))


def data_stream(vocab_size: int, global_batch: int, seq_len: int, *, seed: int = 0,
                start_step: int = 0, device="cuda", mesh: Optional[EpMesh] = None,
                rules: Optional[dict] = None) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The JAX package's stream: the same tokens for the same arguments (a
    rank's rows of them under a mesh)."""
    for toks, labels in batches(vocab_size, global_batch, seq_len, seed=seed, start_step=start_step):
        yield device_put_batch(toks, labels, device, mesh, rules)
