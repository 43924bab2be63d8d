"""The training entry of the dry-run's steps (``repro/launch/steps.py``:
``make_train_entry``), on the card unless the tensors lie on the CPU.

One step accumulates the gradients of ``accum_steps`` microbatches (rows of
the batch in order), in f32, or in bf16 for models past
``_BF16_OPT_THRESHOLD`` parameters (``opt_dtype_for``), divides them by the
count, then takes one AdamW step.  A ``source`` batch (encoder-decoder
models) is encoded under grad (``models/model.py::encode_train``), so the
encoder trains too; a ``prefix`` batch (vlm) prepends its patch embeddings.
``remat`` recomputes each layer in the backward (``torch.utils.checkpoint``).
Under a mesh (``mesh``, ``rules``) every rank takes the global batch, as
JAX's step takes the global arrays: each microbatch is a block of global
rows, and a rank computes its rows of it (``data/pipeline.py::local_rows``,
JAX's split of each microbatch over the batch axes); the gradients and
AdamW are the trainer's expert-parallel ones (``training/trainer.py``:
``DistCtx``, ZeRO-1).

The abstract parameter and input specs (``abstract_params``,
``input_specs``, ``entry_for``) belong to the dry-run and are not here.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, count_params
from repro_torch.data.pipeline import local_rows
from repro_torch.models.model import encode_train, forward, trainable
from repro_torch.parallel.sharding import EpMesh
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_update
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.trainer import DistCtx, cross_entropy, leaf_grads, moe_aux_coef

# Parameter budget above which the gradients accumulate in bf16 (a 1T-param
# model's f32 accumulator would not fit the JAX package's pods)
_BF16_OPT_THRESHOLD = 2e11


def opt_dtype_for(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if count_params(cfg) > _BF16_OPT_THRESHOLD else torch.float32


# The JAX package's perf toggles that take effect in the port: the default
# depth of the accumulation.  JAX's other two have their own place here:
# ``bf16_bwd`` is ``models/transformer.set_bf16_bwd``, and ``shard_grads``
# (each microbatch's gradients constrained to the ZeRO layout) is what the
# ZeRO-1 step always does (it reduce-scatters the replicated leaves'
# gradients).
TRAIN_OPTS = {"accum_steps": 8}


def diff_device(leaves: dict) -> torch.device:
    return next(iter(leaves.values())).device


def make_train_entry(cfg: ModelConfig, *, remat: bool = True, accum_steps: Optional[int] = None,
                     mesh: Optional[EpMesh] = None, rules: Optional[dict] = None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics):
    ``batch`` a dict of ``tokens``, ``labels`` and ``source`` or ``prefix``
    where the family takes them (the global batch, under a mesh too); AdamW at lr 1e-4 under a 100-step warmup
    and a 10000-step cosine; the parameters and moments updated in place.
    ``opt_state``: ``training/trainer.py::init_opt_state(params,
    step.dist_ctx)``."""
    if accum_steps is None:
        accum_steps = TRAIN_OPTS["accum_steps"]
    opt = AdamWConfig(lr=1e-4)
    ctx = DistCtx(cfg, mesh, rules) if mesh is not None else None
    coef = moe_aux_coef(cfg)

    def rows_of(mb: dict) -> dict:
        """This rank's rows of a (micro)batch of global rows."""
        if ctx is None:
            return mb
        rows = local_rows(ctx.mesh, ctx.rules, next(iter(mb.values())).shape[0])
        return {k: v[rows] for k, v in mb.items()}

    def loss_fn(params, mb):
        """(the loss to differentiate, the loss, ce, aux)."""
        memory = encode_train(cfg, params, mb["source"]) if "source" in mb else None
        logits, aux = forward(cfg, params, mb["tokens"], memory=memory,
                              prefix_embeds=mb.get("prefix"), remat=remat)
        if "prefix" in mb:
            logits = logits[:, mb["prefix"].shape[1]:]
        ce = cross_entropy(logits, mb["labels"])
        if ctx is None:
            loss = ce + coef * aux
            return loss, loss.detach(), ce.detach(), aux.detach()
        gce = ctx.global_ce(ce)
        return ctx.share(ce, aux), gce + coef * aux.detach(), gce, aux.detach()

    def train_step(params, opt_state: AdamWState, batch: dict):
        leaves = trainable(params)
        if ctx is not None:
            ctx.partition(leaves)
        gb = next(iter(batch.values())).shape[0]
        A = accum_steps if (accum_steps > 1 and gb % accum_steps == 0) else 1
        with ctx.scope() if ctx is not None else contextlib.nullcontext():
            if A > 1:
                adt = opt_dtype_for(cfg)  # f32 accumulation; bf16 for ~200B-parameter models
                grads = {k: torch.zeros(v.shape, dtype=adt, device=v.device)
                         for k, v in leaves.items()}
                loss_sum = torch.zeros((), dtype=torch.float32, device=diff_device(leaves))
                n = gb // A
                for a in range(A):
                    mb = rows_of({k: v[a * n:(a + 1) * n] for k, v in batch.items()})
                    with torch.enable_grad():
                        diff, loss, _, _ = loss_fn(params, mb)
                    for k, g in leaf_grads(diff, leaves).items():
                        grads[k] += g.to(adt)
                    loss_sum = loss_sum + loss.float()
                for g in grads.values():
                    g /= A
                loss = loss_sum / A
                metrics = {"ce": loss, "aux": torch.zeros((), dtype=torch.float32)}
            else:
                with torch.enable_grad():
                    diff, loss, ce, aux = loss_fn(params, rows_of(batch))
                grads = leaf_grads(diff, leaves)
                metrics = {"ce": ce, "aux": aux}
            lr_scale = warmup_cosine(opt_state.step, warmup_steps=100, decay_steps=10_000)
            kw = {} if ctx is None else dict(parts=ctx.parts, mesh=ctx.mesh)
            _, opt_state, stats = adamw_update(opt, grads, opt_state, leaves, lr_scale, **kw)
        return params, opt_state, dict(metrics, loss=loss, **stats)

    train_step.dist_ctx = ctx
    return train_step
