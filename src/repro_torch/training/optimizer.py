"""AdamW as the JAX package writes it (``repro/training/optimizer.py``):
f32 first and second moments, global-norm clipping, bias correction from
the step, decoupled weight decay on leaves with ``ndim >= 2`` only, the
update made in f32 and cast to the parameter's type.

``torch.optim.AdamW`` decays every tensor and orders the arithmetic
differently, so it is not used.  The update is plain tensor code (JAX
computes it outside any Pallas kernel too), in place: parameters and
moments are updated where they lie, a leaf at a time in chunks of
``CHUNK`` values, so the f32 temporaries of a 1.3 G-value expert leaf stay
a few hundred MB.  Each chunk follows JAX's expression in its order of
roundings.

Under expert parallelism (``parts``, ``parallel/params.py::zero_partition``)
the optimizer state is sharded ZeRO-1 style, the JAX docstring's sharded
moments: a replicated leaf's f32 ``m`` / ``v`` are kept for this rank's
1/dp slice of it only, and its step is reduce-scatter the gradient over the
batch axes (its sum: ``parallel/collectives.py``'s convention), update the
slice, all-gather the parameter; an expert shard keeps whole local moments.
The global norm takes every distinct part once (a ZeRO slice's squares
summed over the batch axes, an expert shard's over the axes that shard it,
never again over ``model`` replicas), decay follows the leaf's own ``ndim``,
and the elementwise update is the one-device path's.  The collectives go a
piece of at most ``CHUNK`` values at a time, so a gloo group stages no more
than that through host memory.

Trees here are ``{path: tensor}`` dicts in one order
(``models/model.py::param_leaves``); the step is a host integer.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

CHUNK = 1 << 26  # values of a leaf updated at a time


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class AdamWConfig(NamedTuple):
    lr: float = 1e-4  # peak; multiplied by schedule(step)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_adamw(params: Dict[str, torch.Tensor], parts: Optional[dict] = None) -> AdamWState:
    """Zero moments; with ``parts`` (ZeRO-1) a replicated leaf's are its
    slice's, ``[size]`` f32."""
    def zeros(k, p):
        shape = (parts[k].size,) if parts is not None and parts[k].zero else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdamWState(0, {k: zeros(k, p) for k, p in params.items()},
                      {k: zeros(k, p) for k, p in params.items()})


def _chunks(t: torch.Tensor):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i : i + CHUNK]


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a 0-d
    f32 tensor on the leaves' device; no host sync)."""
    total = None
    for leaf in tree.values():
        s = sum(torch.sum(torch.square(c.float())) for c in _chunks(leaf))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _f32_scalar(x) -> float:
    """A value rounded to f32, as a Python float (JAX's weak-typed scalars
    meet f32 arrays in f32)."""
    return torch.tensor(x, dtype=torch.float32).item()


class _Consts(NamedTuple):
    b1c: float
    b2c: float
    lr: float
    b1: float
    b2: float
    one_b1: float
    one_b2: float
    eps: float
    wd: float


def _constants(cfg: AdamWConfig, step: int, lr_scale) -> _Consts:
    stepf = torch.tensor(float(step), dtype=torch.float32)
    b1c = (1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf).item()
    b2c = (1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf).item()
    lr = (torch.tensor(cfg.lr, dtype=torch.float32) * torch.as_tensor(lr_scale, dtype=torch.float32)
          .cpu()).item()
    return _Consts(b1c, b2c, lr, _f32_scalar(cfg.b1), _f32_scalar(cfg.b2),
                   _f32_scalar(1 - cfg.b1), _f32_scalar(1 - cfg.b2), _f32_scalar(cfg.eps),
                   _f32_scalar(cfg.weight_decay))


def _update(pc, gc, mc, vc, clip, decay: bool, k: _Consts) -> None:
    """One chunk of AdamW in place: JAX's expression in its order."""
    g = gc.float()
    if clip is not None:
        g = g * clip
    mc.mul_(k.b1).add_(g * k.one_b1)  # m_ = b1 m + (1 - b1) g
    vc.mul_(k.b2).add_((g * k.one_b2).mul_(g))  # v_ = b2 v + (1 - b2) g g
    denom = (vc / k.b2c).sqrt_().add_(k.eps)  # sqrt(vhat) + eps
    delta = (mc / k.b1c).div_(denom)
    p32 = pc.float()
    if decay:  # decoupled weight decay on matrices only
        delta.add_(p32 * k.wd)
    pc.copy_(p32.sub_(delta.mul_(k.lr)))


def _clip(cfg: AdamWConfig, gnorm):
    return torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip > 0 else None


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], lr_scale, *, parts: Optional[dict] = None,
                 mesh=None) -> tuple:
    """One AdamW step.  ``params`` and the moments are updated in place;
    returns (params, new state, {"grad_norm": 0-d tensor}), the JAX
    function's triple.  ``lr_scale``: the schedule's multiplier.  With
    ``parts`` (ZeRO-1 under ``mesh``) ``grads`` holds this rank's gradients
    of its share of the loss, and is emptied leaf by leaf as they are
    reduced."""
    if parts is not None:
        return _zero_update(cfg, grads, state, params, lr_scale, parts, mesh)
    gnorm = global_norm(grads)
    clip = _clip(cfg, gnorm)
    step = state.step + 1
    k = _constants(cfg, step, lr_scale)
    for key, p in params.items():
        decay = p.dim() >= 2
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(grads[key]), _chunks(state.m[key]),
                                  _chunks(state.v[key])):
            _update(pc, gc, mc, vc, clip, decay, k)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------


def _bounds(part, i: int, k0: int, k1: int):
    """Values [k0, k1) of rank i's slice, as flat positions of the leaf (cut
    at its end)."""
    a = min(i * part.size + k0, part.numel)
    return a, min(i * part.size + k1, part.numel)


def _pieces(part):
    step = max(1, CHUNK // part.dp)
    for k0 in range(0, part.size, step):
        yield k0, min(part.size, k0 + step)


def scatter_grad(g: torch.Tensor, part, mesh) -> torch.Tensor:
    """This rank's slice ``[size]`` of the gradient summed over
    ``part.axes``: a reduce-scatter a piece at a time (piece k of every
    rank's slice side by side, the leaf's end padded with zeros)."""
    from repro_torch.parallel import collectives as col

    flat = g.reshape(-1)
    if part.dp == 1:
        return flat
    out = torch.empty(part.size, dtype=g.dtype, device=g.device)
    for k0, k1 in _pieces(part):
        piece = torch.zeros((part.dp, k1 - k0), dtype=g.dtype, device=g.device)
        for i in range(part.dp):
            a, b = _bounds(part, i, k0, k1)
            piece[i, :b - a] = flat[a:b]
        out[k0:k1] = col.psum_scatter(piece.view(-1), mesh, part.axes)
    return out


def gather_param(p: torch.Tensor, part, mesh) -> None:
    """Every rank's updated slice of ``p`` into ``p`` (in place): an
    all-gather over ``part.axes`` a piece at a time."""
    from repro_torch.parallel import collectives as col

    if part.dp == 1:
        return
    flat = p.view(-1)
    for k0, k1 in _pieces(part):
        a, b = _bounds(part, part.index, k0, k1)
        mine = torch.zeros(k1 - k0, dtype=p.dtype, device=p.device)
        mine[:b - a] = flat[a:b]
        got = col.all_gather(mine, mesh, part.axes).view(part.dp, k1 - k0)
        for i in range(part.dp):
            a, b = _bounds(part, i, k0, k1)
            flat[a:b] = got[i, :b - a]


def _zero_update(cfg, grads, state, params, lr_scale, parts, mesh):
    from repro_torch.parallel import collectives as col

    # the gradients of the global loss: a replicated leaf's slice of the sum
    # over the batch axes, an expert shard's own (summed over any batch axis
    # that does not shard it)
    local = {}
    for key in list(params):
        g, part = grads.pop(key), parts[key]
        if part.zero:
            n = _bounds(part, part.index, 0, part.size)
            local[key] = scatter_grad(g, part, mesh)[:n[1] - n[0]]
        else:
            local[key] = col.psum(g, mesh, part.axes) if part.axes else g
        del g
    # the global norm: each distinct part's squares once
    sums = {}
    for key, g in local.items():
        s = sum(torch.sum(torch.square(c.float())) for c in _chunks(g)) if g.numel() else \
            torch.zeros((), dtype=torch.float32, device=g.device)
        axes = parts[key].norm_axes
        sums[axes] = s if axes not in sums else sums[axes] + s
    total = None
    for axes, s in sums.items():
        s = col.psum(s, mesh, axes) if axes else s
        total = s if total is None else total + s
    gnorm = torch.sqrt(total)
    clip = _clip(cfg, gnorm)
    step = state.step + 1
    k = _constants(cfg, step, lr_scale)
    for key, p in params.items():
        part, g = parts[key], local.pop(key)
        decay = p.dim() >= 2
        if part.zero:
            a, b = _bounds(part, part.index, 0, part.size)
            target = p.view(-1)[a:b]
            m, v = state.m[key][:b - a], state.v[key][:b - a]
        else:
            target, m, v = p, state.m[key], state.v[key]
        for pc, gc, mc, vc in zip(_chunks(target), _chunks(g), _chunks(m), _chunks(v)):
            _update(pc, gc, mc, vc, clip, decay, k)
        if part.zero:
            gather_param(p, part, mesh)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
