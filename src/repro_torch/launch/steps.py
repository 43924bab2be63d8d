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

The dry run's abstract specs live here too, on ``device="meta"`` (shapes
and dtypes, nothing allocated): ``abstract_params`` (``init_params`` on
meta, cut under a mesh to one rank's leaves by ``parallel/params.py``'s
rules), ``abstract_opt_state`` (AdamW's moments in f32, as the port's
``init_adamw`` allocates them at every size; under a mesh ZeRO-1's slice
of each replicated leaf),
``abstract_caches``, ``input_specs`` (the entry's arguments for an
``InputShape``: every rank takes the global batch, as above) and
``entry_for`` (the train, prefill or decode entry a shape's kind runs).
JAX's abstract moments take ``opt_dtype_for``'s dtype (bf16 past
``_BF16_OPT_THRESHOLD`` parameters) while its trainer allocates f32; the
port sizes them as its trainer allocates them, so the dry run reports the
bytes the trainer would hold.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, count_params
from repro_torch.configs.shapes import InputShape
from repro_torch.data.pipeline import local_rows
from repro_torch.models.model import (decode_step, encode_train, forward, init_caches,
                                      init_params, param_leaves, prefill, trainable)
from repro_torch.parallel.params import shard_params, zero_partition
from repro_torch.parallel.sharding import DEFAULT_RULES
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


def make_prefill_entry(cfg: ModelConfig):
    def prefill_step(params, tokens, caches, memory=None, prefix=None):
        return prefill(cfg, params, tokens, caches, memory=memory, prefix_embeds=prefix)

    return prefill_step


def make_decode_entry(cfg: ModelConfig):
    def decode_one(params, token, index, caches, memory=None):
        return decode_step(cfg, params, token, index, caches, memory=memory)

    return decode_one


def entry_for(cfg: ModelConfig, kind: str):
    if kind == "train":
        return make_train_entry(cfg)
    if kind == "prefill":
        return make_prefill_entry(cfg)
    return make_decode_entry(cfg)


# ---------------------------------------------------------------------------
# Abstract specs on the meta device (the dry run)
# ---------------------------------------------------------------------------


def paper_mesh(shape, axis_names=("data",), rank: int = 0) -> EpMesh:
    """Rank ``rank``'s view of a mesh with no process group: enough for
    ``shard_params`` and ``zero_partition`` to cut a rank's leaves (every
    rank's are the same size)."""
    from repro_torch.parallel.sharding import coords_of

    shape = tuple(int(n) for n in shape)
    return EpMesh(shape, tuple(axis_names), rank, coords_of(rank, shape), None)


def abstract_params(cfg: ModelConfig, mesh: Optional[EpMesh] = None, *, mode: str = "serve",
                    rules: Optional[dict] = None):
    """The parameter tree on ``device="meta"``; under ``mesh``, one rank's
    leaves (experts sharded, the rest replicated: the port's layout)."""
    params = init_params(cfg, device="meta")
    if mesh is None:
        return params
    return shard_params(mesh, rules or DEFAULT_RULES, params, cfg, mode=mode)


def abstract_opt_state(cfg: ModelConfig, params, mesh: Optional[EpMesh] = None,
                       rules: Optional[dict] = None) -> AdamWState:
    """AdamW's moments for ``params`` (a rank's, under ``mesh``) on meta, in
    f32 as ``init_adamw`` allocates them; under a mesh a replicated leaf's
    moments are its ZeRO-1 slice."""
    leaves = param_leaves(params)
    parts = zero_partition(mesh, rules or DEFAULT_RULES, leaves, cfg) if mesh is not None else None

    def zeros(k, p):
        shape = (parts[k].size,) if parts is not None and parts[k].zero else p.shape
        return torch.empty(shape, dtype=torch.float32, device="meta")

    return AdamWState(0, {k: zeros(k, p) for k, p in leaves.items()},
                      {k: zeros(k, p) for k, p in leaves.items()})


def abstract_caches(cfg: ModelConfig, batch: int, capacity: int, mesh: Optional[EpMesh] = None,
                    *, cross_len: int = 0) -> dict:
    """The contiguous caches on meta (replicated under a mesh: every rank
    holds every row, ``serving/ep.py::place_caches``)."""
    return init_caches(cfg, batch, capacity, cross_len=cross_len, device="meta")


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "vlm" and cfg.frontend is not None:
        return max(seq_len - cfg.frontend.n_tokens, 1)
    return seq_len


def input_specs(cfg: ModelConfig, shape: InputShape, mesh: Optional[EpMesh] = None) -> dict:
    """The entry's arguments for ``shape`` on meta, ``{"args": (...)}`` in
    the order ``entry_for(cfg, shape.kind)`` takes them (the global batch on
    every rank)."""
    from repro_torch.models.modules import DTYPES

    GB, S = shape.global_batch, shape.seq_len
    dt = DTYPES[cfg.param_dtype]
    meta = lambda *s, dtype=dt: torch.empty(s, dtype=dtype, device="meta")
    tok = lambda s: meta(GB, s, dtype=torch.long)
    fe = cfg.frontend
    cross = fe.n_tokens if cfg.family == "encdec" else 0
    if shape.kind == "train":
        st = _text_len(cfg, S)
        batch = {"tokens": tok(st), "labels": tok(st)}
        if cfg.family == "vlm":
            batch["prefix"] = meta(GB, fe.n_tokens, fe.embed_dim)
        if cfg.family == "encdec":
            batch["source"] = meta(GB, fe.n_tokens, fe.embed_dim)
        params = abstract_params(cfg, mesh, mode="train")
        return {"args": (params, abstract_opt_state(cfg, params, mesh), batch)}
    params = abstract_params(cfg, mesh)
    caches = abstract_caches(cfg, GB, S, mesh, cross_len=cross)
    memory = meta(GB, fe.n_tokens, cfg.d_model) if cfg.family == "encdec" else None
    if shape.kind == "prefill":
        prefix = meta(GB, fe.n_tokens, fe.embed_dim) if cfg.family == "vlm" else None
        return {"args": (params, tok(_text_len(cfg, S)), caches, memory, prefix)}
    return {"args": (params, tok(1), S - 1, caches, memory)}
