"""Top-level model (``repro/models/model.py``): embeddings -> segments ->
final norm -> logits.

Entry points: ``init_params``, ``init_caches``, ``forward`` (teacher-forced
logits), ``prefill`` (logits of the last position, caches filled),
``decode_step`` (one token, caches updated in place) and ``encode`` (the
encoder stack of an encoder-decoder model; ``encode_train`` under grad); for contiguous
continuous batching ``prefill_into_slot`` and ``ragged_decode_step``; for
paged serving ``init_paged_caches``, ``paged_prefill_chunk``,
``paged_prefill_chunk_batched``, ``paged_prefill_into_slot`` (the scatter
oracle), ``paged_ragged_decode_step``, ``paged_reset_pages``,
``paged_copy_page`` (copy-on-write) and ``paged_copy_slot_leaves``; for
speculative decoding ``paged_verify_chunk_batched`` and
``paged_reset_page_tails``.
Layers whose state is not paged (sliding-window rings, Mamba-2 SSD and
RG-LRU states) keep it per slot, ``[repeats, slots, ...]`` beside the page
pool, as the JAX package does: a paged decode merges those leaves under the
rows' ``active`` mask, a chunk resumes them (or, for an admission's first
chunk, starts them fresh), and the scatter and contiguous admissions prefill
them in the slot's row.
Frontend-stub models take precomputed frame or patch embeddings: a learned
projector (``frontend_proj``) maps them to d_model, and they feed the
encoder (audio encoder-decoder: ``encode``, whose output is the ``memory``
the decoder's cross attention reads) or are prepended to the token
embeddings (vlm: ``prefix_embeds``).
Parameters live in a :class:`ParamTree`, an ``nn.Module`` whose nesting and
leaf names are the JAX package's parameter tree, so a JAX tree converts leaf
for leaf (``repro_torch.convert``).
Under an expert-parallel serving mesh the caches may be placed by slot
(``SlotCaches``, ``serving/ep.py::place_caches``): each rank holds its block
of the per-slot leaves' rows, and the entry points that run every slot
(``prefill``, ``decode_step``, ``ragged_decode_step``,
``paged_ragged_decode_step``, ``paged_prefill_chunk_batched``) run the
embedding, attention, norms, dense FFNs and logits on the rank's rows only
(JAX's ``shard_hint(x, "batch", ...)``): their inputs are the whole batch's,
replicated, and their logits the rank's rows.  The MoE layers see the token
set JAX's layer sees (``core/moe.py``), and the writes into a replicated
page pool take every row's K/V, so every rank's pool stays the same bytes.
The one-slot entries (``prefill_into_slot``, ``paged_prefill_chunk``,
``paged_prefill_into_slot``) run replicated, as JAX's ``B = 1`` hints do:
the rank that holds the slot sends its per-slot row to the others before
the step and alone keeps the row the step wrote; ``paged_copy_slot_leaves``
sends a row from its owner to the destination's.
Training: ``forward`` is differentiable (every other entry point runs under
``torch.no_grad``), with ``remat`` and ``return_routing`` as in JAX;
``param_leaves`` lists the tree's tensors in the JAX tree's order and
``trainable`` sets their ``requires_grad``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import AttnSpec, ModelConfig
from repro_torch.models.attention import _paged_clamp_table, spec_is_paged
from repro_torch.models.modules import DTYPES, dense_init, embed_init, init_rmsnorm, rmsnorm
from repro_torch.models.transformer import apply_segment, init_segment, init_segment_cache
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import RowShard, shard_hint, use_rows
from repro_torch.quant.kv import QuantizedKV
from repro_torch.quant.qarrays import materialize


class ParamTree(nn.Module):
    """A nested dict of tensors held as an ``nn.Module``: inner dicts become
    submodules, tensors buffers, ``QuantizedArray`` leaves stay modules.  Reads like the dict it was built from
    (``p["segments"]["seg0"]``), and ``.to()`` / ``state_dict()`` work."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if torch.is_tensor(v):
                self.register_buffer(k, v)
            else:
                # a QuantizedArray (a module of its own) nests as it is
                self.add_module(k, v if isinstance(v, nn.Module) else ParamTree(v))

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def items(self):
        return [(k, self[k]) for k in self._keys]


def param_leaves(params) -> dict:
    """``{path: tensor}`` of every leaf of a ParamTree (or nested dict), in
    the JAX tree's flattening order (keys sorted at every level), path
    ``"segments/seg0/pos1/moe/wi"`` as in the checkpoint manifest.  The
    tensors are the tree's own (no copy)."""
    out = {}

    def walk(node, prefix):
        for k in sorted(node._keys if isinstance(node, ParamTree) else node):
            v = node[k]
            if torch.is_tensor(v):
                out[prefix + k] = v
            elif isinstance(v, (dict, ParamTree)):
                walk(v, prefix + k + "/")
            else:
                raise TypeError(f"param_leaves: leaf {prefix + k!r} is a {type(v).__name__}, "
                                "not a tensor (quantized trees do not train)")

    walk(params, "")
    return out


def trainable(params, on: bool = True) -> dict:
    """Set ``requires_grad`` of every leaf of ``params`` (in place) and
    return ``param_leaves``: the tensors a training step differentiates and
    updates."""
    leaves = param_leaves(params)
    for t in leaves.values():
        t.requires_grad_(on)
    return leaves


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` without an index names the
    current card, and raises where there is none."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> ParamTree:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (``device="meta"`` gives shapes only); an
    encoder-decoder config also gets ``encoder`` (its segments and final
    norm), a frontend config ``frontend_proj`` [embed_dim, d_model]."""
    device = resolve_device(device)
    dt = DTYPES[cfg.param_dtype]
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    p = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": init_rmsnorm(cfg.d_model, dt, device),
        "segments": {f"seg{i}": init_segment(gen, cfg, seg, dt, device)
                     for i, seg in enumerate(cfg.segments)},
    }
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device).T.contiguous()  # [D, V]
    if cfg.encoder is not None:
        p["encoder"] = {
            "segments": {f"seg{i}": init_segment(gen, cfg, seg, dt, device)
                         for i, seg in enumerate(cfg.encoder.segments)},
            "final_norm": init_rmsnorm(cfg.d_model, dt, device),
        }
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(gen, cfg.frontend.embed_dim, cfg.d_model, dt, device)
    return ParamTree(p)


def init_caches(cfg: ModelConfig, batch: int, capacity: int, *, cross_len: int = 0,
                kv_bits: int = 0, device="cuda") -> dict:
    """Contiguous KV caches, ``[repeats, batch, capacity, ...]`` per segment
    position; ``kv_bits=8`` stores K/V as int8 ``QuantizedKV`` (quantized on
    write), 0 in full precision.  Cross-attention layers get a cross cache
    of ``max(cross_len, 1)`` entries, full precision."""
    device = resolve_device(device)
    dt = DTYPES[cfg.param_dtype]
    return {f"seg{i}": init_segment_cache(cfg, seg, batch, capacity, dt, device, kv_bits=kv_bits,
                                          cross_len=cross_len)
            for i, seg in enumerate(cfg.segments)}


def init_paged_caches(cfg: ModelConfig, slots: int, capacity: int, *, n_pages: int,
                      page_size: int, kv_bits: int = 0, device="cuda") -> dict:
    """Paged serving caches: every global self-attention layer's K/V lives
    in a shared page pool ``[repeats, n_pages + 1, page_size, Hkv, dh]``
    addressed through per-slot block tables; window rings and SSM / LRU
    states stay per slot, ``[repeats, slots, ...]``.  ``capacity`` stays the
    per-sequence context bound (it sizes the tables and the rings, not the
    pool).  ``kv_bits=8`` makes the pages and rings int8 with per-(token,
    head) scales."""
    device = resolve_device(device)
    dt = DTYPES[cfg.param_dtype]
    return {f"seg{i}": init_segment_cache(cfg, seg, slots, capacity, dt, device,
                                          pages=(n_pages, page_size), kv_bits=kv_bits)
            for i, seg in enumerate(cfg.segments)}


class SlotCaches(dict):
    """A cache tree placed by slot under an expert-parallel serving mesh:
    its per-slot leaves hold rows ``[rows.lo, rows.hi)`` of ``rows.n``
    slots (``rows`` a ``RowShard``; None: every slot's row), its pools every
    page.  Reads as the dict it was built from."""

    def __init__(self, tree: dict, rows: Optional[RowShard]):
        super().__init__(tree)
        self.rows = rows


def slot_rows(caches) -> Optional[RowShard]:
    """The ``RowShard`` of a cache tree placed by slot, None where every
    rank holds every slot's row."""
    return getattr(caches, "rows", None)


def _step_rows(caches, n: int) -> Optional[RowShard]:
    """The rows this rank runs of a step over every one of the ``n`` slots
    of ``caches``; None: every row."""
    rows = slot_rows(caches)
    if rows is not None and rows.n != n:
        raise ValueError(f"a step over {n} rows of caches placed for {rows.n} slots")
    return rows


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]  # [B, S, D]
    # the scale is rounded to x's type first, as in JAX; a 0-d CPU tensor
    # joins a CUDA product as a scalar, without a host-to-device copy
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def logits_out(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    w = params["embed"].T if cfg.tie_embeddings else materialize(params["unembed"])
    return x @ w.to(x.dtype)


def _with_prefix(cfg: ModelConfig, params, x: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The token embeddings x [B, S, D] with the projected patch embeddings
    ``prefix_embeds`` [B, P, De] prepended (vlm), or x as it is."""
    if prefix_embeds is None:
        return x
    pre = prefix_embeds.to(x.dtype) @ materialize(params["frontend_proj"])
    return torch.cat([pre, x], dim=1)


# ---------------------------------------------------------------------------
# Encoder (encoder-decoder models)
# ---------------------------------------------------------------------------


@torch.no_grad()
def encode(cfg: ModelConfig, params, source: torch.Tensor) -> torch.Tensor:
    """The encoder stack: ``source`` [B, T, frontend.embed_dim] (stubbed
    frontend embeddings, projected by ``frontend_proj``) or token ids [B,
    T]; its segments in ``train`` mode (every self-attention layer through
    kernel 6, non-causal), then the encoder's final norm -> the memory [B,
    T, d_model]."""
    return encode_train(cfg, params, source)


def encode_train(cfg: ModelConfig, params, source: torch.Tensor) -> torch.Tensor:
    """``encode`` under the caller's grad mode: differentiable, as the
    training entry's loss needs it (the encoder's kernels take their
    backward kernels, as ``forward``'s do)."""
    if cfg.frontend is not None and source.ndim == 3:
        x = source.to(DTYPES[cfg.compute_dtype]) @ materialize(params["frontend_proj"])
    else:
        x = embed_tokens(cfg, params, source)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
    enc = params["encoder"]
    for i, seg in enumerate(cfg.encoder.segments):
        x, _, _ = apply_segment(cfg, seg, enc["segments"][f"seg{i}"], x, pos, mode="train")
    return rmsnorm(enc["final_norm"], x, cfg.rms_eps)


# ---------------------------------------------------------------------------
# Decoder entry points
# ---------------------------------------------------------------------------


def _run_segments(cfg, params, x, positions, caches, mode, index=None, block_table=None,
                  memory=None, remat=False, collect_stats=False):
    """(x, caches, aux); with ``collect_stats`` a fourth element, ``{seg{i}:
    {pos{j}: RoutingStats [repeats, ...]}}`` for every MoE position."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = {}
    for i, seg in enumerate(cfg.segments):
        c = caches[f"seg{i}"] if caches is not None else None
        out = apply_segment(cfg, seg, params["segments"][f"seg{i}"], x, positions,
                            caches=c, mode=mode, index=index, block_table=block_table,
                            memory=memory, remat=remat, collect_stats=collect_stats)
        x, a = out[0], out[2]
        # analysis: allow(tracer-branch) — out[3] is a dict of routing stats
        if collect_stats and out[3]:
            stats[f"seg{i}"] = out[3]
        aux = aux + a
    return (x, caches, aux, stats) if collect_stats else (x, caches, aux)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None, memory: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None, remat: bool = False,
            return_routing: bool = False) -> Tuple[torch.Tensor, ...]:
    """Teacher-forced logits [B, S (+ P), V] and the summed aux loss;
    ``memory`` the encoder output the cross attention reads, ``prefix_embeds``
    [B, P, De] patch embeddings prepended to the tokens.  Differentiable:
    under grad, with the parameters ``trainable``, the kernels take their
    backward kernels (6b, 1b, 2b, 4b) and a kernel without one raises.  ``remat``
    recomputes each layer in the backward; ``return_routing`` appends the
    per-layer routing-stats tree (``core/gating.py::summarize_routing``)."""
    x = _with_prefix(cfg, params, embed_tokens(cfg, params, tokens), prefix_embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
    out = _run_segments(cfg, params, x, positions, None, "train", memory=memory, remat=remat,
                        collect_stats=return_routing)
    logits = logits_out(cfg, params, out[0])
    return (logits, out[2], out[3]) if return_routing else (logits, out[2])


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, caches: dict, *,
            memory: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """Returns (logits for the last position [B, V], caches filled in place);
    ``memory`` and ``prefix_embeds`` as in ``forward`` (the cross caches are
    written from the memory).  Over caches placed by slot: the rank's rows
    of the logits."""
    with use_rows(_step_rows(caches, tokens.shape[0])):
        tokens, memory, prefix_embeds = (shard_hint(t, "batch") for t in (tokens, memory,
                                                                          prefix_embeds))
        x = _with_prefix(cfg, params, embed_tokens(cfg, params, tokens), prefix_embeds)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
        x, caches, _ = _run_segments(cfg, params, x, positions, caches, "prefill", memory=memory)
        return logits_out(cfg, params, x[:, -1:])[:, 0], caches


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: torch.Tensor, index: int,
                caches: dict, *, memory: Optional[torch.Tensor] = None,
                return_routing: bool = False) -> Tuple:
    """One decode step at absolute position ``index`` (uniform over the
    batch): returns (logits [B, V], caches updated in place).  The cross
    attention reads its cache; ``memory`` keeps JAX's signature.
    ``return_routing=True`` appends the routing-stats tree (on the device,
    ``core/gating.py::routing_to_host`` copies it).  Over caches placed by
    slot: the rank's rows of the logits."""
    with use_rows(_step_rows(caches, token.shape[0])):
        x = embed_tokens(cfg, params, shard_hint(token, "batch"))
        positions = torch.full((x.shape[0], 1), index, dtype=torch.int32, device=x.device)
        out = _run_segments(cfg, params, x, positions, caches, "decode", index=index,
                            memory=shard_hint(memory, "batch"), collect_stats=return_routing)
        return (logits_out(cfg, params, out[0])[:, 0], out[1]) + out[3:]


def _tensors(tree):
    """Every tensor of a cache tree: the (q, scale) pair of a ``QuantizedKV``."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, QuantizedKV):
        yield tree.q
        yield tree.scale
    else:
        for v in tree.values():
            yield from _tensors(v)


def _map_tensors(tree, fn):
    """The tree with ``fn`` applied to every tensor (``QuantizedKV`` kept)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, QuantizedKV):
        return QuantizedKV(fn(tree.q), fn(tree.scale), tree.orig_dtype)
    return {k: _map_tensors(v, fn) for k, v in tree.items()}


def _fresh(ls, t: torch.Tensor) -> int:
    """A fresh cache's value of tensor ``t`` of layer ``ls``: -1 for an
    attention cache's positions (empty slots), 0 everywhere else."""
    return -1 if isinstance(ls.mixer, AttnSpec) and t.dtype == torch.int32 else 0


def _slot_leaves(cfg: ModelConfig, caches: dict, paged: bool):
    """(LayerSpec, leaf) of every cache leaf held per slot ``[repeats,
    slots, ...]``: under paged serving (``paged``) every leaf but the pools,
    in the contiguous caches every leaf."""
    for sk, pk, ls, pooled in _layer_entries(cfg):
        for key, leaf in caches[sk][pk].items():
            if not (paged and key == "self" and pooled):
                yield ls, leaf


def _reset_rows(cfg: ModelConfig, caches: dict, rows, paged: bool) -> None:
    """The per-slot leaves' rows ``rows`` (a slot index, or a bool [slots]
    mask on the device) back to a fresh cache's values, in place."""
    for ls, leaf in _slot_leaves(cfg, caches, paged):
        for t in _tensors(leaf):
            if torch.is_tensor(rows):
                m = rows.reshape((1, -1) + (1,) * (t.ndim - 2))
                t.copy_(torch.where(m, torch.full((), _fresh(ls, t), dtype=t.dtype, device=t.device), t))
            else:
                t[:, int(rows)].fill_(_fresh(ls, t))


class _RowMerge:
    """What a step that runs every slot row writes into the per-slot leaves,
    put back for the rows outside ``active`` [slots] bool after the step
    (JAX's masked merge of the whole leaves): an attention cache's step
    writes one entry per row, at slot ``pos % cap``, so only that entry is
    kept (``positions`` [slots]); a recurrent state is rewritten whole, so
    it is kept whole (``positions`` None: every leaf kept whole).  No step
    copies a ring."""

    def __init__(self, cfg: ModelConfig, caches: dict, paged: bool, positions=None):
        self.saved = []
        if positions is not None:
            rows = torch.arange(positions.shape[0], device=positions.device)
        for ls, leaf in _slot_leaves(cfg, caches, paged):
            for t in _tensors(leaf):
                if positions is not None and isinstance(ls.mixer, AttnSpec):
                    slot = positions.long() % t.shape[2]  # [repeats, slots, capacity, ...]
                    self.saved.append((t, (slice(None), rows, slot), t[:, rows, slot].clone()))
                else:
                    self.saved.append((t, (slice(None),), t.clone()))

    def restore(self, active: torch.Tensor) -> None:
        for t, idx, old in self.saved:
            keep = active.reshape((1, -1) + (1,) * (old.ndim - 2))
            t[idx] = torch.where(keep, t[idx], old)


# ---------------------------------------------------------------------------
# Contiguous continuous batching (one cache row per slot)
# ---------------------------------------------------------------------------


@torch.no_grad()
def ragged_decode_step(cfg: ModelConfig, params, token: torch.Tensor, positions: torch.Tensor,
                       active: torch.Tensor, caches: dict, *,
                       return_routing: bool = False) -> Tuple:
    """Continuous-batching decode tick over contiguous slot caches: token [B,
    1] at per-row ``positions`` [B]; ``active`` [B] bool.  Returns (logits
    [B, V], caches updated in place); ``return_routing=True`` appends the
    routing-stats tree, which covers every slot row, the inactive ones too
    (as JAX's: a sample of the load's shape, not exact counts).

    Every row is written and attends, as in JAX (an inactive row at its
    position, 0 from the engine, so under a capacity dispatch it routes as
    JAX's does); then what each row wrote is put back for the inactive rows
    (``_RowMerge``: one entry per attention cache, the whole recurrent
    states), which is JAX's masked merge of the whole cache restricted to
    what the step touched: inactive rows stay bit-identical, and no step
    copies a KV cache.  Over caches placed by slot: the rank's rows, of the
    logits too."""
    with use_rows(_step_rows(caches, token.shape[0])):
        token, pos, active = (shard_hint(t, "batch") for t in (token, positions.to(torch.int32),
                                                                active))
        x = embed_tokens(cfg, params, token)
        merge = _RowMerge(cfg, caches, False, pos)
        out = _run_segments(cfg, params, x, pos[:, None], caches, "decode_ragged",
                            collect_stats=return_routing)
        merge.restore(active)
        return (logits_out(cfg, params, out[0])[:, 0], caches) + out[3:]


@torch.no_grad()
def prefill_into_slot(cfg: ModelConfig, params, tokens: torch.Tensor, positions: torch.Tensor,
                      slot: int, caches: dict) -> Tuple[torch.Tensor, dict]:
    """Prefill one request (tokens [1, S] at ``positions`` [1, S]) into row
    ``slot`` of the pooled slot caches, in place: the row is reset to a fresh
    cache (K/V 0, positions -1, recurrent states 0), as JAX writes a fresh
    single-row cache over it, and the prefill writes its first S entries (a
    ring its last ones; kernel 6 attends).  Returns (logits of the last
    position [1, V], caches)."""
    with _one_slot(cfg, caches, slot, True, False) as row:
        x = embed_tokens(cfg, params, tokens)
        x, _, _ = _run_segments(cfg, params, x, positions.to(torch.int32), row, "prefill")
    return logits_out(cfg, params, x[:, -1:])[:, 0], caches


# ---------------------------------------------------------------------------
# Paged serving entry points (shared page pool + per-slot block tables)
# ---------------------------------------------------------------------------


def _layer_entries(cfg: ModelConfig):
    """Yield (seg_key, pos_key, LayerSpec, paged_self) over the decoder."""
    for i, seg in enumerate(cfg.segments):
        for j, ls in enumerate(seg.pattern):
            paged = isinstance(ls.mixer, AttnSpec) and spec_is_paged(ls.mixer)
            yield f"seg{i}", f"pos{j}", ls, paged


def arch_fully_paged(cfg: ModelConfig) -> bool:
    """True iff every sequence-mixing layer's state lives in the shared page
    pool under paged serving (no window rings, no SSM/LRU states)."""
    return all(paged for _, _, _, paged in _layer_entries(cfg))


def _pool_layer(cfg: ModelConfig, caches: dict) -> Optional[dict]:
    """The first paged layer's pool (every paged layer has the same layout);
    None for an arch without one (mamba2, recurrentgemma)."""
    return next((caches[sk][pk]["self"] for sk, pk, _, paged in _layer_entries(cfg) if paged),
                None)


def _clamped(cfg: ModelConfig, caches: dict, table: torch.Tensor) -> torch.Tensor:
    """The block table with -1 entries clamped to the trash page, once per
    call rather than in every layer (every paged layer shares one pool size)."""
    pool = _pool_layer(cfg, caches)
    return table.to(torch.int32) if pool is None else _paged_clamp_table(table, pool["pos"].shape[-2])


def _row_tree(cfg: ModelConfig, caches: dict, paged: bool, fn) -> dict:
    """The caches' tree with every per-slot leaf's tensors ``t`` replaced by
    ``fn(ls, t)`` (``ls`` the leaf's LayerSpec) and the pools (``paged``) as
    they are."""
    out = {}
    for sk, pk, ls, pooled in _layer_entries(cfg):
        out.setdefault(sk, {})[pk] = {
            key: leaf if (paged and key == "self" and pooled)
            else _map_tensors(leaf, lambda t, ls=ls: fn(ls, t))
            for key, leaf in caches[sk][pk].items()}
    return out


def _row_tensors(cfg: ModelConfig, tree: dict, paged: bool) -> list:
    """The per-slot tensors of a cache tree, in a fixed order."""
    return [t for _, leaf in _slot_leaves(cfg, tree, paged) for t in _tensors(leaf)]


def slot_cache_bytes(cfg: ModelConfig, caches: dict, paged: bool) -> Tuple[int, int]:
    """(bytes of the per-slot leaves, bytes of the rest: the pools) of a
    cache tree as held (a placed tree: this rank's rows)."""
    from repro_torch.quant.kv import kv_cache_bytes

    per = sum(t.numel() * t.element_size() for t in _row_tensors(cfg, caches, paged))
    return per, kv_cache_bytes(dict(caches)) - per


def _broadcast_row(rows: RowShard, tensors: list, row: int) -> None:
    """Fill ``tensors`` (contiguous) on every rank with the values they hold
    on the ranks that hold global row ``row``: one broadcast of their bytes
    over ``rows``' axes."""
    if not tensors:
        return
    flat = [t.view(-1).view(torch.uint8) for t in tensors]
    buf = col.broadcast(torch.cat(flat), rows.mesh, rows.axes, rows.block(row))
    o = 0
    for f in flat:
        f.copy_(buf[o : o + f.numel()])
        o += f.numel()


@contextlib.contextmanager
def _one_slot(cfg: ModelConfig, caches: dict, slot: Optional[int], reset: bool, paged: bool):
    """The cache tree of a one-row step of slot ``slot``: the pools as they
    are, the per-slot leaves as the slot's row (fresh first if ``reset``).
    Over caches placed by slot every rank runs the step: each gets a
    contiguous copy of the row (the holder's values, broadcast, unless
    ``reset``), and on exit the ranks that hold the slot copy it back."""
    if paged and arch_fully_paged(cfg):
        yield caches
        return
    if slot is None:
        raise ValueError(f"{cfg.name} keeps per-slot state: pass the chunk's slot")
    slot = int(slot)
    rows = slot_rows(caches)
    if rows is None:
        if reset:
            _reset_rows(cfg, caches, slot, paged)
        yield _row_tree(cfg, caches, paged, lambda ls, t: t[:, slot : slot + 1])
        return
    mine = rows.holds(slot)
    r = slot - rows.lo
    if mine and not reset:
        one = _row_tree(cfg, caches, paged, lambda ls, t: t[:, r : r + 1].clone(
            memory_format=torch.contiguous_format))
    else:
        one = _row_tree(cfg, caches, paged, lambda ls, t: torch.full_like(
            t[:, :1], _fresh(ls, t), memory_format=torch.contiguous_format))
    if not reset:
        _broadcast_row(rows, _row_tensors(cfg, one, paged), slot)
    yield one
    if mine:
        for dst, src in zip(_row_tensors(cfg, caches, paged), _row_tensors(cfg, one, paged)):
            dst[:, r] = src[:, 0]


@torch.no_grad()
def paged_ragged_decode_step(cfg: ModelConfig, params, token: torch.Tensor, positions: torch.Tensor,
                             caches: dict, block_table: torch.Tensor,
                             active: Optional[torch.Tensor] = None, *,
                             return_routing: bool = False) -> Tuple:
    """Continuous-batching decode tick over paged caches: token [B, 1] at
    per-row ``positions`` [B]; ``block_table`` [B, max_pages] int32 with -1
    unmapped.  Returns (logits [B, V], caches updated in place);
    ``return_routing=True`` appends the routing-stats tree (every slot row,
    as ``ragged_decode_step``'s).

    The pool writes mask themselves: an inactive row's table row is all -1,
    so its write lands in the trash page with position -1, and its
    attention sees no valid key (its logits are discarded).  The per-slot
    leaves (window rings, SSM / LRU states) of the rows outside ``active``
    [B] bool are put back after the step (``_RowMerge``), JAX's masked
    merge; ``active`` None: every row decodes.  Over caches placed by slot
    the rank runs its rows (logits too), and every row's K/V goes into the
    replicated pool."""
    pos = positions.to(torch.int32)
    table = _clamped(cfg, caches, block_table)
    with use_rows(_step_rows(caches, token.shape[0])):
        token, pos, table, active = (shard_hint(t, "batch") for t in (token, pos, table, active))
        x = embed_tokens(cfg, params, token)
        merge = (_RowMerge(cfg, caches, True, pos)
                 if active is not None and not arch_fully_paged(cfg) else None)
        out = _run_segments(cfg, params, x, pos[:, None], caches, "decode_paged",
                            block_table=table, collect_stats=return_routing)
        if merge is not None:
            merge.restore(active)
        return (logits_out(cfg, params, out[0])[:, 0], caches) + out[3:]


@torch.no_grad()
def paged_reset_pages(cfg: ModelConfig, caches: dict, page_mask: torch.Tensor) -> dict:
    """Invalidate pages returned to the pool, in place: ``page_mask``
    [n_pages + 1] bool -> those pages' ``pos`` entries become -1 in every
    layer's pool.  Required for correctness: a recycled page's leftover
    positions (which can be <= the new owner's query position) would
    otherwise unmask its previous occupant's K/V."""
    for sk, pk, _, paged in _layer_entries(cfg):
        if paged:
            caches[sk][pk]["self"]["pos"].masked_fill_(page_mask[None, :, None], -1)
    return caches


@torch.no_grad()
def paged_prefill_chunk(cfg: ModelConfig, params, tokens: torch.Tensor, positions: torch.Tensor,
                        caches: dict, table_row: torch.Tensor, *, slot: Optional[int] = None,
                        reset: bool = False) -> Tuple[torch.Tensor, dict]:
    """One chunk of a resumable admission prefill, written straight into
    pool pages: tokens [1, C] at absolute ``positions`` [1, C] (the chunk
    start .. end - 1), ``table_row`` [max_pages] the slot's block table with
    every page the chunk writes already mapped.  Each layer attends over the
    sequence's already-written pages plus the chunk's own K/V (kernel 8) and
    then writes the chunk's K/V into its pages.  Returns (logits of the
    chunk's last position [1, V], caches updated in place).

    The per-slot leaves of row ``slot`` (window rings, SSM / LRU states)
    advance by the chunk: a ring appends at ``pos % cap`` after attending
    over ``cat(ring, chunk)``, a recurrence resumes from its state and conv
    prefix.  ``reset`` (an admission's first chunk) starts them from a fresh
    cache's values instead: the row still holds its previous occupant's
    state."""
    x = embed_tokens(cfg, params, tokens)
    with _one_slot(cfg, caches, slot, reset, True) as one:
        x, _, _ = _run_segments(cfg, params, x, positions.to(torch.int32), one, "prefill_chunk",
                                block_table=_clamped(cfg, caches, table_row[None]))
    return logits_out(cfg, params, x[:, -1:])[:, 0], caches


@torch.no_grad()
def paged_prefill_chunk_batched(cfg: ModelConfig, params, tokens: torch.Tensor,
                                positions: torch.Tensor, reset: torch.Tensor, active: torch.Tensor,
                                last_idx: torch.Tensor, caches: dict,
                                block_tables: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Every mid-prefill slot advances one chunk in ONE call (the batched
    prefill tick): tokens [S, C] (0-padded), ``positions`` [S, C] (-1 at
    padding, all -1 for a row without a chunk), ``block_tables`` [S,
    max_pages] (-1 unmapped, all -1 for an inactive row).  Each layer
    attends through one launch of the batched kernel 8 and writes every
    row's chunk into its pages; padding and inactive rows write to the
    trash page.  Returns (logits at each row's last valid token
    ``last_idx`` [S] -> [S, V], caches updated in place).

    The per-slot leaves (window rings, SSM / LRU states) of the ``reset``
    [S] rows start from a fresh cache's values, every row's advance by its
    chunk (padding is inert: ring writes keep a row's last valid tokens, an
    SSD step with dt = 0 and an LRU step with a = 1, b = 0 are the
    identity), and the rows outside ``active`` [S] are put back as they
    came in, JAX's masked merge.  Over caches placed by slot the rank runs
    its rows (logits too), and every row's chunk goes into the replicated
    pool."""
    S = tokens.shape[0]
    if reset.shape != (S,) or active.shape != (S,) or last_idx.shape != (S,):
        raise ValueError(f"paged_prefill_chunk_batched: reset {tuple(reset.shape)}, active "
                         f"{tuple(active.shape)}, last_idx {tuple(last_idx.shape)} for {S} rows")
    pos = positions.to(torch.int32)
    table = _clamped(cfg, caches, block_tables)
    with use_rows(_step_rows(caches, S)):
        tokens, pos, table, reset, active, last_idx = (
            shard_hint(t, "batch") for t in (tokens, pos, table, reset, active, last_idx))
        x = embed_tokens(cfg, params, tokens)
        merge = None
        if not arch_fully_paged(cfg):
            merge = _RowMerge(cfg, caches, True)
            _reset_rows(cfg, caches, reset, True)
        x, caches, _ = _run_segments(cfg, params, x, pos, caches, "prefill_chunk_batched",
                                     block_table=table)
        if merge is not None:
            merge.restore(active)
        xe = x[torch.arange(x.shape[0], device=x.device), last_idx.long()]  # [S, D]
        return logits_out(cfg, params, xe[:, None])[:, 0], caches


@torch.no_grad()
def paged_verify_chunk_batched(cfg: ModelConfig, params, tokens: torch.Tensor,
                               positions: torch.Tensor, active: torch.Tensor, caches: dict,
                               block_tables: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Speculative VERIFY: every decoding slot's window (its unwritten
    current token and its k drafted tokens) scored in ONE batched pass,
    ``paged_prefill_chunk_batched`` without an admission reset: tokens [S,
    C], ``positions`` [S, C] (-1 at padding; an inactive row all -1 with an
    all -1 table row), ``block_tables`` [S, max_pages] whose window entries
    point at the copy-on-write forks and fresh pages the scheduler planned,
    so a rejected write is rolled back by dropping pages.  Each layer
    attends through one launch of the batched kernel 8.  Returns (logits at
    EVERY window position [S, C, V]: position j scores the token at
    ``positions[:, j] + 1``, caches updated in place).

    The per-slot leaves (window rings, SSM / LRU states) come back
    unchanged, as in JAX: a rejection could not roll them back, so only pool
    pages are written.  ``active`` [S] bool keeps JAX's signature."""
    S = tokens.shape[0]
    if active.shape != (S,):
        raise ValueError(f"paged_verify_chunk_batched: active {tuple(active.shape)} for {S} rows")
    if slot_rows(caches) is not None:
        raise NotImplementedError("paged_verify_chunk_batched over caches placed by slot: "
                                  "speculative decoding does not run over an expert-parallel mesh")
    x = embed_tokens(cfg, params, tokens)
    merge = _RowMerge(cfg, caches, True) if not arch_fully_paged(cfg) else None
    x, caches, _ = _run_segments(cfg, params, x, positions.to(torch.int32), caches,
                                 "prefill_chunk_batched",
                                 block_table=_clamped(cfg, caches, block_tables))
    if merge is not None:
        merge.restore(torch.zeros_like(active))
    return logits_out(cfg, params, x), caches


@torch.no_grad()
def paged_reset_page_tails(cfg: ModelConfig, caches: dict, pages: torch.Tensor,
                           start_offs: torch.Tensor) -> dict:
    """Invalidate the tail of each slot's last committed page, in place:
    offsets >= ``start_offs[i]`` of page ``pages[i]`` [S] get ``pos = -1`` in
    every paged layer's pool (``pages[i] = -1`` rows match nothing,
    ``start_offs[i] = page_size`` touches nothing); one fixed-shape mask for
    every slot and layer.

    Required for correctness: a committed window page still holds the
    verify pass's writes beyond the accepted point (rejected drafts).  The
    next window writes those positions for real, and the ``already``-stored
    write guard (``models/attention.py``) would send that K/V to the trash
    page.  After the reset a live page holds no position >= its slot's
    length."""
    pool = _pool_layer(cfg, caches)
    if pool is None:
        return caches
    P, ps = pool["pos"].shape[1:]
    hit = torch.arange(P, device=pages.device)[None, :] == pages[:, None]  # [S, P]
    offm = torch.arange(ps, device=pages.device)[None, :] >= start_offs[:, None]  # [S, ps]
    mask = (hit[:, :, None] & offm[:, None, :]).any(0)  # [P, ps]
    for sk, pk, _, paged in _layer_entries(cfg):
        if paged:
            caches[sk][pk]["self"]["pos"].masked_fill_(mask[None], -1)
    return caches


@torch.no_grad()
def paged_copy_page(cfg: ModelConfig, caches: dict, src: int, dst: int) -> dict:
    """Copy physical page ``src`` to ``dst`` in every paged layer's pool, in
    place on the device: k, v and pos, an int8 pool's (q, scale) pairs as
    they are.  The device half of copy-on-write: the scheduler calls it
    after ``KVBlockPool.fork`` and before the slot's next append, so the
    shared original is never written.  ``src`` / ``dst`` are the host's
    page ids: no read of a device value."""
    for sk, pk, _, paged in _layer_entries(cfg):
        if paged:
            for t in _tensors(caches[sk][pk]["self"]):  # [repeats, n_pages + 1, page_size, ...]
                t[:, dst] = t[:, src]
    return caches


@torch.no_grad()
def paged_copy_slot_leaves(cfg: ModelConfig, caches: dict, src: int, dst: int) -> dict:
    """Copy row ``src`` to ``dst`` of every cache leaf that is NOT a shared
    page pool (window rings, SSM/LRU states, cross caches: ``[repeats,
    slots, ...]``), in place.  A parallel-sample fork shares its base's
    pages through its table and takes the rest this way (the shared pools:
    the table carries the fork).  Over caches placed by slot, rows held by
    other ranks go by one broadcast from the source's holders."""
    rows = slot_rows(caches)
    if rows is None:
        for t in _row_tensors(cfg, caches, True):
            t[:, dst] = t[:, src]
        return caches
    local = _row_tensors(cfg, caches, True)
    if rows.block(src) == rows.block(dst):
        if rows.holds(src):
            for t in local:
                t[:, dst - rows.lo] = t[:, src - rows.lo]
        return caches
    # the row goes from the ranks that hold ``src`` to those that hold ``dst``
    sent = [(t[:, src - rows.lo : src - rows.lo + 1] if rows.holds(src) else t[:, :1])
            .clone(memory_format=torch.contiguous_format) for t in local]
    _broadcast_row(rows, sent, src)
    if rows.holds(dst):
        for t, row in zip(local, sent):
            t[:, dst - rows.lo] = row[:, 0]
    return caches


@torch.no_grad()
def paged_prefill_into_slot(cfg: ModelConfig, params, tokens: torch.Tensor,
                            positions: torch.Tensor, caches: dict, table_row: torch.Tensor, *,
                            scatter_start: int = 0,
                            slot: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """One-shot admission prefill, the parity oracle of chunked prefill
    (``prefill_mode="scatter"``): the contiguous prefill of tokens [1, S]
    into a temporary single-sequence cache (kernel 6, numerics of the
    static path), then its K/V (an int8 cache's (q, scale) pairs as they
    are) scattered into the pages of ``table_row`` [max_pages] (-1
    unmapped), in place.  Positions below ``scatter_start`` lie in pages
    shared with other slots: their writes, and unmapped ones, go to the
    trash page with position -1, so a shared page is never written (the
    compute still covers them).  The per-slot leaves (window rings, SSM /
    LRU states) are prefilled in row ``slot``, reset first, as JAX writes
    the temporary cache's row over them.  Returns (logits of the last
    position [1, V], caches)."""
    S = tokens.shape[1]
    kv_bits = 8 if any(isinstance(leaf.get("k"), QuantizedKV)
                       for _, leaf in _slot_leaves(cfg, caches, False)) else 0
    tmp = init_caches(cfg, 1, S, kv_bits=kv_bits, device=tokens.device)
    x = embed_tokens(cfg, params, tokens)
    pos = positions.to(torch.int32)
    with _one_slot(cfg, caches, slot, True, True) as row:
        for sk, pk, _, paged in _layer_entries(cfg):
            if not paged:
                tmp[sk][pk] = row[sk][pk]  # the slot's own leaves, prefilled in place
        x, tmp, _ = _run_segments(cfg, params, x, pos, tmp, "prefill")
    logits = logits_out(cfg, params, x[:, -1:])[:, 0]
    pos_vec = pos[0]
    for sk, pk, _, paged in _layer_entries(cfg):
        if not paged:
            continue
        pool, one = caches[sk][pk]["self"], tmp[sk][pk]["self"]
        Pt, ps = pool["pos"].shape[1:]
        pages = table_row.long()[pos_vec.long() // ps]
        pages = torch.where((pages < 0) | (pos_vec < scatter_start), Pt - 1, pages)
        offs = pos_vec.long() % ps
        for name in ("k", "v"):
            for dst, val in zip(_tensors(pool[name]), _tensors(one[name])):
                dst[:, pages, offs] = val[:, 0, :S].to(dst.dtype)
        pool["pos"][:, pages, offs] = torch.where(pages == Pt - 1, -1, pos_vec).expand(
            pool["pos"].shape[0], S)
    return logits, caches
