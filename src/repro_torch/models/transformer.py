"""Block and segment assembly (``repro/models/transformer.py``).

A block is a pre-norm mixer (attention, Mamba-2 SSD or RG-LRU) [+ a pre-norm
cross attention over the encoder memory, in an encoder-decoder's decoder] + a
pre-norm FFN (dense, MoE or none), all residual.
Parameters and caches of a segment keep the JAX package's layout, stacked on
a leading ``[repeats]`` axis; the JAX ``lax.scan`` over repeats becomes a
Python loop over repeat ``r``'s views of both (``unbind``, ``take``).
``remat=True`` (training) recomputes each layer in the backward
(``torch.utils.checkpoint``, the counterpart of JAX's ``jax.checkpoint`` of
the scan body) under the mesh ambient at its forward, and ``collect_stats=True`` returns each MoE position's
``RoutingStats`` stacked over the repeats, as JAX's scan stacks them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttnSpec, LayerSpec, LRUSpec, ModelConfig, Segment, SSMSpec
from repro_torch.core.moe import init_moe, moe_layer
from repro_torch.models.attention import (
    attention,
    check_spec,
    init_attention,
    init_kv_cache,
    init_paged_kv_cache,
    spec_is_paged,
)
from repro_torch.core.gating import stack_stats
from repro_torch.models.modules import grad_cast, init_mlp, init_rmsnorm, mlp, rmsnorm
from repro_torch.models.rglru import init_lru, init_lru_cache, lru_layer
from repro_torch.models.ssm import init_ssm, init_ssm_cache, ssm_layer
from repro_torch.parallel.sharding import get_mesh, get_rules, use_mesh
from repro_torch.quant.kv import QuantizedKV
from repro_torch.quant.qarrays import QuantizedArray


def check_layer(ls: LayerSpec) -> None:
    if isinstance(ls.mixer, AttnSpec):
        check_spec(ls.mixer)
    elif not isinstance(ls.mixer, (SSMSpec, LRUSpec)):
        raise TypeError(ls.mixer)
    if ls.cross is not None:
        check_spec(ls.cross)


def init_layer(gen, cfg: ModelConfig, ls: LayerSpec, dtype, device, *, lead=()) -> dict:
    check_layer(ls)
    p = {"norm_mixer": init_rmsnorm(cfg.d_model, dtype, device, lead=lead)}
    m = ls.mixer
    if isinstance(m, AttnSpec):
        p["attn"] = init_attention(gen, cfg, m, dtype, device, lead=lead)
    elif isinstance(m, SSMSpec):
        p["ssm"] = init_ssm(gen, cfg, m, dtype, device, lead=lead)
    else:
        p["lru"] = init_lru(gen, cfg, m, dtype, device, lead=lead)
    if ls.cross is not None:
        p["norm_cross"] = init_rmsnorm(cfg.d_model, dtype, device, lead=lead)
        p["cross"] = init_attention(gen, cfg, ls.cross, dtype, device, lead=lead)
    if ls.ffn.kind == "dense":
        p["norm_ffn"] = init_rmsnorm(cfg.d_model, dtype, device, lead=lead)
        p["ffn"] = init_mlp(gen, cfg.d_model, ls.ffn.d_ff, ls.ffn.act, dtype, device, lead=lead)
    elif ls.ffn.kind == "moe":
        p["norm_ffn"] = init_rmsnorm(cfg.d_model, dtype, device, lead=lead)
        p["moe"] = init_moe(gen, cfg, ls.ffn, dtype, device, lead=lead)
    return p


def init_layer_cache(cfg: ModelConfig, ls: LayerSpec, batch: int, capacity: int, dtype, device,
                     *, lead=(), pages=None, kv_bits: int = 0, cross_len: int = 0) -> dict:
    """``capacity`` is the full-context length of a global layer's cache; a
    sliding-window layer gets a ring of ``min(window, capacity)`` slots.
    ``pages = (n_pages, page_size)`` puts a global layer's K/V into a shared
    page pool addressed through block tables (paged serving); rings and
    SSM / LRU states stay per-slot (``batch`` rows).  ``kv_bits=8`` stores
    self-attention K/V as int8 ``QuantizedKV`` (recurrent states stay
    full precision).  A layer with cross attention also gets a ``cross``
    cache of ``max(cross_len, 1)`` entries per row, full precision."""
    check_layer(ls)
    m = ls.mixer
    if isinstance(m, SSMSpec):
        c = {"self": init_ssm_cache(batch, m, dtype, device, lead=lead)}
    elif isinstance(m, LRUSpec):
        c = {"self": init_lru_cache(batch, m, dtype, device, lead=lead)}
    elif pages is not None and spec_is_paged(m):
        n_pages, page_size = pages
        c = {"self": init_paged_kv_cache(n_pages, page_size, cfg.num_kv_heads, cfg.head_dim,
                                         dtype, device, lead=lead, kv_bits=kv_bits)}
    else:
        cap = min(m.window, capacity) if (m.kind == "local" and m.window > 0) else capacity
        c = {"self": init_kv_cache(batch, cap, cfg.num_kv_heads, cfg.head_dim, dtype, device,
                                   lead=lead, kv_bits=kv_bits)}
    if ls.cross is not None:
        c["cross"] = init_kv_cache(batch, max(cross_len, 1), cfg.num_kv_heads, cfg.head_dim,
                                   dtype, device, lead=lead)
    return c


def apply_layer(
    cfg: ModelConfig,
    ls: LayerSpec,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    index: Optional[int] = None,
    block_table: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
    collect_stats: bool = False,
):
    """Returns (x, cache, aux_loss); the cache is updated in place.
    ``memory`` [B, T, d] is the encoder output a cross-attention sublayer
    attends over.  ``collect_stats=True`` appends the MoE layer's
    ``RoutingStats`` (None for a layer without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = None
    h = rmsnorm(params["norm_mixer"], x, cfg.rms_eps)
    sc = cache.get("self") if cache is not None else None
    m = ls.mixer
    if isinstance(m, AttnSpec):
        y, _ = attention(cfg, m, params["attn"], h, positions, cache=sc, mode=mode, index=index,
                         block_table=block_table)
    elif isinstance(m, SSMSpec):
        y, _ = ssm_layer(cfg, m, params["ssm"], h, cache=sc, mode=mode, positions=positions)
    else:
        y, _ = lru_layer(cfg, m, params["lru"], h, cache=sc, mode=mode, positions=positions)
    x = x + y
    if ls.cross is not None:
        h = rmsnorm(params["norm_cross"], x, cfg.rms_eps)
        y, _ = attention(cfg, ls.cross, params["cross"], h, positions, memory=memory, mode=mode,
                         cache=cache.get("cross") if cache is not None else None)
        x = x + y
    if ls.ffn.kind == "dense":
        h = rmsnorm(params["norm_ffn"], x, cfg.rms_eps)
        x = x + mlp(params["ffn"], h, ls.ffn.act)
    elif ls.ffn.kind == "moe":
        h = rmsnorm(params["norm_ffn"], x, cfg.rms_eps)
        if collect_stats:
            y, aux, stats = moe_layer(cfg, ls.ffn, params["moe"], h, with_stats=True)
        else:
            y, aux = moe_layer(cfg, ls.ffn, params["moe"], h)
        x = x + y
    if BF16_BWD[0]:
        x = grad_cast(x)
    if collect_stats:
        return x, cache, aux, stats
    return x, cache, aux


# ---------------------------------------------------------------------------
# Segment (loop over repeats)
# ---------------------------------------------------------------------------


def take(tree, r: int):
    """Repeat ``r``'s views of a ``[repeats, ...]``-stacked tree (quantized
    leaves and caches included)."""
    if torch.is_tensor(tree) or isinstance(tree, QuantizedKV):
        return tree[r]
    if isinstance(tree, QuantizedArray):
        return tree.take(r)
    return {k: take(v, r) for k, v in tree.items()}


def in_ambient_mesh(fn):
    """``fn`` under the mesh and rules ambient now.  The autograd engine
    runs a CUDA backward on a thread of its own, where the caller's mesh is
    not ambient, and a layer ``remat`` recomputes there must see it (the
    expert-parallel layer reads it)."""
    mesh, rules = get_mesh(), get_rules()
    if mesh is None:
        return fn

    def run(*args, **kw):
        with use_mesh(mesh, rules):
            return fn(*args, **kw)
    return run


def unbind(tree, n: int) -> list:
    """Every repeat's views of a ``[repeats, ...]``-stacked parameter tree at
    once (``torch.unbind``; quantized leaves through ``take``): under grad,
    one leaf's gradient is then one stack of the repeats' gradients, where
    an index per repeat would give each repeat's gradient as a zero-filled
    tensor of the whole leaf."""
    if torch.is_tensor(tree):
        return list(tree.unbind(0))
    if isinstance(tree, QuantizedArray):
        return [tree.take(r) for r in range(n)]
    parts = {k: unbind(v, n) for k, v in tree.items()}
    return [{k: parts[k][r] for k in parts} for r in range(n)]


def init_segment(gen, cfg: ModelConfig, seg: Segment, dtype, device) -> dict:
    return {f"pos{j}": init_layer(gen, cfg, ls, dtype, device, lead=(seg.repeats,))
            for j, ls in enumerate(seg.pattern)}


def init_segment_cache(cfg: ModelConfig, seg: Segment, batch: int, capacity: int, dtype,
                       device, *, pages=None, kv_bits: int = 0, cross_len: int = 0) -> dict:
    return {f"pos{j}": init_layer_cache(cfg, ls, batch, capacity, dtype, device, lead=(seg.repeats,),
                                        pages=pages, kv_bits=kv_bits, cross_len=cross_len)
            for j, ls in enumerate(seg.pattern)}


def apply_segment(
    cfg: ModelConfig,
    seg: Segment,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    caches: Optional[dict] = None,
    mode: str = "train",
    index: Optional[int] = None,
    block_table: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
    remat: bool = False,
    collect_stats: bool = False,
):
    """Returns (x, caches, aux_sum); ``caches`` mirror the params with a
    leading ``repeats`` axis and are written in place.  ``block_table`` (the
    paged modes) and ``memory`` (cross attention) are the same for every
    layer.  ``remat``: each layer is recomputed in the backward (no cache:
    the training forward).  ``collect_stats``: a fourth element, ``{pos{j}:
    RoutingStats [repeats, ...]}`` for the pattern's MoE positions."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = {f"pos{j}": [] for j, ls in enumerate(seg.pattern) if ls.ffn.kind == "moe"}
    per_repeat = {k: unbind(v, seg.repeats) for k, v in params.items()}
    for r in range(seg.repeats):
        for j, ls in enumerate(seg.pattern):
            key = f"pos{j}"
            c = take(caches[key], r) if caches is not None else None
            p = per_repeat[key][r]
            kw = dict(cache=c, mode=mode, index=index, block_table=block_table, memory=memory,
                      collect_stats=collect_stats)
            if remat and caches is None:
                out = checkpoint(in_ambient_mesh(apply_layer), cfg, ls, p, x, positions,
                                 use_reentrant=False, **kw)
            else:
                out = apply_layer(cfg, ls, p, x, positions, **kw)
            x, a = out[0], out[2]
            if collect_stats and key in stats:
                stats[key].append(out[3])
            aux = aux + a
    if collect_stats:
        return x, caches, aux, {k: stack_stats(v) for k, v in stats.items()}
    return x, caches, aux


# The bf16 backward switch (``repro/models/transformer.py``'s ``BF16_BWD``):
# cast the residual stream's gradient to the activation type at every layer
# boundary (``models/modules.py::grad_cast``).
BF16_BWD = [False]


def set_bf16_bwd(on: bool) -> None:
    BF16_BWD[0] = bool(on)
