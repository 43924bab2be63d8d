"""Batches on a device (``repro/data/pipeline.py``): the synthetic stream's
numpy (tokens, labels) as int64 tensors on an explicit device.  The JAX
package shards them over a mesh's batch axes; that branch belongs to
expert-parallel training (ROADMAP queue 1 item 7b), so a batch goes whole
to one device."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import batches


def device_put_batch(tokens: np.ndarray, labels: np.ndarray,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(np.asarray(tokens, np.int64)).to(device),
            torch.from_numpy(np.asarray(labels, np.int64)).to(device))


def data_stream(vocab_size: int, global_batch: int, seq_len: int, *, seed: int = 0,
                start_step: int = 0,
                device="cuda") -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The JAX package's stream: the same tokens for the same arguments."""
    for toks, labels in batches(vocab_size, global_batch, seq_len, seed=seed, start_step=start_step):
        yield device_put_batch(toks, labels, device)
