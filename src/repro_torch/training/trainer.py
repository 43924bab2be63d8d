"""The trainer (``repro/training/trainer.py``): the loss, the train step and
a small driver loop, on the card unless the caller asks for the CPU.

A step differentiates the port's ``forward`` with autograd: attention goes
through kernel 6 and its backward 6b, capacity gating through kernel 1 and
its backward 1b (``dense`` / ``einsum`` dispatch), SwiGLU experts through
kernels 2 / 2b (capacity buffer) or 4 / 4b (``grouped``), and every other
product through PyTorch.  Unlike JAX's functional step, the parameters and AdamW
moments are updated in place; ``make_train_step``'s step returns them all
the same, so it is called as JAX's is.

Under a mesh (``mesh``, ``rules``: expert-parallel training, one process per
rank) the step takes this rank's rows of the global batch
(``data/pipeline.py``) and a tree placed by
``parallel/params.py::shard_params(mode="train")``; ``moe_impl="ep"``
layers run ``core/moe_parallel.py``.  Each rank differentiates its share of
the loss (``parallel/collectives.py``'s convention), and AdamW reduces the
replicated leaves' gradients over the batch axes with ZeRO-1 moments
(``training/optimizer.py``).  The metrics hold the global loss, ce and aux,
the same on every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gating import summarize_routing
from repro_torch.models.model import forward, init_params, trainable
from repro_torch.parallel.params import batch_axes, zero_partition
from repro_torch.parallel.sharding import EpMesh, use_mesh
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw
from repro_torch.training.schedule import warmup_cosine


def moe_aux_coef(cfg: ModelConfig) -> float:
    for ls in cfg.layer_specs():
        if ls.ffn.kind == "moe":
            return ls.ffn.aux_loss_coef
    return 0.0


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in f32.  logits [B, S, V], labels [B, S] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(cfg: ModelConfig, params, tokens, labels, *, remat: bool = False, memory=None,
            prefix_embeds=None, return_routing: bool = False):
    """(loss, metrics): CE plus the MoE aux loss times its coefficient;
    ``return_routing=True`` adds the forward's per-layer routing-stats tree
    under ``"routing"`` (the same gating decisions the aux loss is built
    from)."""
    out = forward(cfg, params, tokens, remat=remat, memory=memory, prefix_embeds=prefix_embeds,
                  return_routing=return_routing)
    logits, aux = out[0], out[1]
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1] :]
    ce = cross_entropy(logits, labels)
    loss = ce + moe_aux_coef(cfg) * aux
    metrics = {"ce": ce, "aux": aux}
    if return_routing:
        metrics["routing"] = out[2]
    return loss, metrics


@dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 50
    decay_steps: int = 1000
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: bool = False


def adamw_config(tc: TrainConfig) -> AdamWConfig:
    return AdamWConfig(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)


def leaf_grads(loss, leaves: dict) -> dict:
    """The gradients of ``loss`` in the leaves; a leaf the loss does not
    reach (internvl2's ``frontend_proj`` without prefix embeddings) gets a
    zero gradient, as ``jax.value_and_grad`` gives it."""
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(leaf) if g is None else g
            for (k, leaf), g in zip(leaves.items(), grads)}


def apply_grads(opt: AdamWConfig, tc: TrainConfig, leaves: dict, loss, opt_state: AdamWState,
                dist_ctx=None):
    """The gradients of ``loss`` in the leaves, then one AdamW step at the
    schedule's multiplier of ``opt_state.step`` (in place); a leaf the loss
    does not reach is still decayed.  ``dist_ctx``: the mesh's ``DistCtx``
    (ZeRO-1).  Returns (state, stats with ``lr_scale``)."""
    grads = leaf_grads(loss, leaves)
    lr_scale = warmup_cosine(opt_state.step, warmup_steps=tc.warmup_steps,
                             decay_steps=tc.decay_steps, min_ratio=tc.min_lr_ratio)
    kw = {} if dist_ctx is None else dict(parts=dist_ctx.parts, mesh=dist_ctx.mesh)
    _, opt_state, stats = adamw_update(opt, grads, opt_state, leaves, lr_scale, **kw)
    return opt_state, dict(stats, lr_scale=lr_scale)


class DistCtx:
    """What a train step under a mesh needs: the mesh and its rules, the
    batch axes and their ranks (``dp``), and each leaf's ZeRO-1 partition
    (``parts``, from the first tree it sees)."""

    def __init__(self, cfg: ModelConfig, mesh: EpMesh, rules: dict):
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.axes = batch_axes(mesh, rules)
        self.dp = mesh.axes_size(self.axes) if self.axes else 1
        self.parts = None

    def partition(self, leaves: dict) -> dict:
        if self.parts is None:
            self.parts = zero_partition(self.mesh, self.rules, leaves, self.cfg)
        return self.parts

    def scope(self):
        return use_mesh(self.mesh, self.rules)

    def share(self, ce: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        """This rank's share of the loss: its rows' CE over ``dp`` (the rows
        are equal parts of the global batch) and the aux loss whole."""
        return ce / self.dp + moe_aux_coef(self.cfg) * aux

    def global_ce(self, ce: torch.Tensor) -> torch.Tensor:
        from repro_torch.parallel import collectives as col

        return col.pmean(ce.detach(), self.mesh, self.axes) if self.axes else ce.detach()


def init_opt_state(params, dist_ctx: Optional[DistCtx] = None) -> AdamWState:
    """AdamW's state for ``params``: whole moments, or under a mesh ZeRO-1
    moments for the replicated leaves."""
    leaves = trainable(params)
    if dist_ctx is None:
        return init_adamw(leaves)
    return init_adamw(leaves, dist_ctx.partition(leaves))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, with_routing: bool = False,
                    mesh: Optional[EpMesh] = None, rules: Optional[dict] = None) -> Callable:
    """step(params, opt_state, tokens, labels) -> (params, opt_state,
    metrics): loss, ce, aux, lr_scale, grad_norm (0-d tensors) and, with
    ``with_routing``, the routing tree.  Under ``mesh`` (with its
    ``rules``), tokens and labels are this rank's rows and ``opt_state``
    comes from ``init_opt_state(params, step.dist_ctx)``."""
    opt = adamw_config(tc)
    ctx = DistCtx(cfg, mesh, rules) if mesh is not None else None

    def train_step(params, opt_state: AdamWState, tokens, labels):
        leaves = trainable(params)
        if ctx is None:
            with torch.enable_grad():
                loss, metrics = loss_fn(cfg, params, tokens, labels, remat=tc.remat,
                                        return_routing=with_routing)
            opt_state, stats = apply_grads(opt, tc, leaves, loss, opt_state)
            ce = metrics["ce"].detach()
        else:
            ctx.partition(leaves)
            with ctx.scope():
                with torch.enable_grad():
                    _, metrics = loss_fn(cfg, params, tokens, labels, remat=tc.remat,
                                         return_routing=with_routing)
                # this rank's share for the gradients, the global loss for the metrics
                share = ctx.share(metrics["ce"], metrics["aux"])
                ce = ctx.global_ce(metrics["ce"])
                loss = ce + moe_aux_coef(cfg) * metrics["aux"].detach()
                opt_state, stats = apply_grads(opt, tc, leaves, share, opt_state, ctx)
        metrics = dict(metrics, loss=loss.detach(), ce=ce, aux=metrics["aux"].detach(), **stats)
        return params, opt_state, metrics

    train_step.dist_ctx = ctx
    return train_step


def train_loop(cfg: ModelConfig, tc: TrainConfig, data_iter, num_steps: int, *, seed: int = 0,
               params=None, log_every: int = 10, log_fn=print, routing_stats: bool = False,
               metrics_sink: Optional[Callable[[dict], None]] = None, device="cuda",
               mesh: Optional[EpMesh] = None, rules: Optional[dict] = None):
    """Returns (params, opt_state, history), with the JAX loop's history
    rows and log line.  ``params`` None: ``init_params(cfg, seed=seed)`` on
    ``device`` (under ``mesh`` placed for training).  ``data_iter`` yields
    this rank's rows under a mesh.  The host reads the metrics (a device
    sync) only at logged steps."""
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
        if mesh is not None:
            from repro_torch.parallel.params import shard_params

            params = shard_params(mesh, rules, params, cfg, mode="train")
    step_fn = make_train_step(cfg, tc, with_routing=routing_stats, mesh=mesh, rules=rules)
    opt_state = init_opt_state(params, step_fn.dist_ctx)
    history = []
    t0 = time.time()
    for step in range(num_steps):
        tokens, labels = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, tokens, labels)
        if step % log_every == 0 or step == num_steps - 1:
            routing = metrics.pop("routing", None)
            m = {k: float(v) for k, v in metrics.items()}
            row = {"step": step, **m}
            line = (f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                    f"aux {m['aux']:.4f} gnorm {m['grad_norm']:.3f}")
            if routing:
                summ = summarize_routing(routing)
                row["routing"] = summ
                line += (f" drop {summ['dropped_frac']:.3f} "
                         f"imb {summ['imbalance']:.3f} ent {summ['entropy']:.3f}")
            line += f" ({time.time() - t0:.1f}s)"
            history.append(row)
            log_fn(line)
            if metrics_sink is not None:
                metrics_sink(row)
    return params, opt_state, history
