"""GQA attention with contiguous, ring and paged KV caches
(``repro/models/attention.py``: global, sliding-window and cross kinds).

Modes ``train`` / ``prefill`` / ``decode`` (uniform batch index) and
``decode_ragged`` (per-row positions, the contiguous continuous engine) run
over contiguous caches; ``decode_paged``, ``prefill_chunk`` and
``prefill_chunk_batched`` (one chunk per slot, the batched prefill tick)
over a shared page pool addressed through block tables, through the
hand-written paged kernels (``kernels/attention_paged.py``,
``kernels/attention_prefill_paged.py``).
A sliding-window layer (kind ``local``) keeps a ring of ``min(window,
capacity)`` slots, token at position p in slot ``p % cap``, its ``pos``
-1 where empty; under paged serving the ring is per slot, beside the pool
(``spec_is_paged``).  Its static prefill attends through kernel 6 with the
window mask and writes only the last ``cap`` tokens; a chunk that resumes a
ring (chunked prefill, contiguous or per slot) attends over ``cat(ring,
chunk)`` through the plain ``_sdpa``, as JAX does (no TPU kernel computes
it), and then writes the chunk into the ring; a decode token goes to slot
``pos % cap`` and attends through ``_sdpa`` (fp) or kernel 9 with the
window (int8).
With ``kv_bits=8`` the caches hold int8 ``QuantizedKV`` pairs, quantized on
every write; decode over a contiguous int8 cache goes through
``kernels/attention_quant.py``, and the paged kernels take their int8
branches.
Caches are updated in place: the stacked ``[repeats, ...]`` tensors the
engines allocate are written through per-layer views, so a step never copies
a cache.  That changes the order of reads and writes against JAX's
functional updates, and every mode keeps JAX's order explicitly: a prefill
chunk attends over the pool BEFORE its K/V are written (over its own fp K/V
in flight), a decode token is written first, quantized where the cache is
int8, and then attends (it sees itself as stored), and a static prefill
attends over its fp K/V and then writes them.  ``train`` and ``prefill``
attend through ``attend_chunked`` / ``attend_full``, which on the card is
one launch of the hand-written flash-attention kernel per layer call
(``kernels/flash_attention.py``, kernel 6: it tiles the queries itself and
never builds the ``[S, T]`` logits) and on the CPU its plain version, which
attends 1024 queries at a time.  The contiguous fp decode (uniform or
ragged) keeps the plain ``_sdpa``, whose softmax runs in f32 exactly as the JAX ``_sdpa``
does (f32 logits, probabilities cast to ``v``'s type).
Cross attention (kind ``cross``, an encoder-decoder's decoder) attends over
the encoder's ``memory`` with no causal mask and no RoPE: at prefill it
projects K/V from the memory, attends through kernel 6 (query positions 0,
key positions the memory's) and writes its per-row cross cache, full
precision whatever the self caches are; a decode step reads that cache
through ``_sdpa``.
In a step whose rows are sharded over an expert-parallel mesh
(``parallel/sharding.py::use_rows``) every rank attends and writes its
per-slot leaves on its own rows; the page pool is replicated, so before a
paged write the ranks gather every row's new K/V (one all-gather a layer)
with their positions and block tables, and each writes them all: every
rank's pool stays the same bytes, as XLA keeps a replicated scatter operand.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import AttnSpec, ModelConfig
from repro_torch.kernels.attention_paged import paged_decode_attention
from repro_torch.kernels.attention_prefill_paged import (
    paged_prefill_attention,
    paged_prefill_attention_batched,
)
from repro_torch.kernels.attention_quant import decode_attention_quant
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.models.modules import apply_rope, dense_init, init_rmsnorm, rmsnorm, softcap
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import get_rows
from repro_torch.quant.kv import QuantizedKV, kv_quantize_values, materialize_kv
from repro_torch.quant.qarrays import materialize

NEG_INF = -1e30


MODES = ("train", "prefill", "decode", "decode_ragged", "decode_paged", "prefill_chunk",
         "prefill_chunk_batched")
PAGED_MODES = ("decode_paged", "prefill_chunk", "prefill_chunk_batched")


def check_spec(spec: AttnSpec) -> None:
    """Raise for an attention kind the JAX package does not have."""
    if spec.kind not in ("global", "local", "cross"):
        raise ValueError(f"unknown attention kind {spec.kind!r}")


def _window(spec: AttnSpec) -> int:
    return spec.window if spec.kind == "local" else 0


# ---------------------------------------------------------------------------
# Params and caches
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, spec: AttnSpec, dtype, device, *, lead=()) -> dict:
    H, Hkv, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, d, (H, dh), dtype, device, lead=lead),
        "wk": dense_init(gen, d, (Hkv, dh), dtype, device, lead=lead),
        "wv": dense_init(gen, d, (Hkv, dh), dtype, device, lead=lead),
        "wo": dense_init(gen, H * dh, d, dtype, device, lead=lead).view(lead + (H, dh, d)),
    }
    if spec.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dtype, device, lead=lead)
        p["k_norm"] = init_rmsnorm(dh, dtype, device, lead=lead)
    return p


def _kv_tensor(shape, dtype, device, kv_bits: int):
    if kv_bits == 8:
        return QuantizedKV.zeros(shape, dtype, device)
    if kv_bits == 0:
        return torch.zeros(shape, dtype=dtype, device=device)
    raise ValueError(f"kv_bits must be 0 (fp) or 8 (int8), got {kv_bits}")


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int, dtype, device,
                  *, lead=(), kv_bits: int = 0) -> dict:
    """Contiguous KV cache; ``pos`` holds the absolute position stored in each
    slot (-1 = empty), which is also the validity mask's source.
    ``kv_bits=8`` stores K/V as int8 ``QuantizedKV`` (quantized on write)."""
    shape = tuple(lead) + (batch, capacity, n_kv, head_dim)
    return {
        "k": _kv_tensor(shape, dtype, device, kv_bits),
        "v": _kv_tensor(shape, dtype, device, kv_bits),
        "pos": torch.full(tuple(lead) + (batch, capacity), -1, dtype=torch.int32, device=device),
    }


def _write_kv(old, new_vals, write) -> None:
    """``write(buffer, values)`` in place: to the tensor of an fp cache, to
    both tensors of a ``QuantizedKV`` (quantize on write: each token's scale
    stands alone, so no earlier entry is rescaled)."""
    if isinstance(old, QuantizedKV):
        q_new, s_new = kv_quantize_values(new_vals)
        write(old.q, q_new)
        write(old.scale, s_new)
    else:
        write(old, new_vals.to(old.dtype))


def _cache_write_prefill(cache: dict, k, v, positions) -> dict:
    """Write a prefill of S tokens (positions [B, S]) in place: into slots
    ``[0, S)``, or, into a ring of cap < S slots, only the last cap tokens,
    token p at slot ``p % cap`` (every slot written)."""
    S = k.shape[1]
    if S > cache["k"].shape[1]:
        return _cache_write_chunk(cache, k, v, positions)

    def write(buf, vals):
        buf[:, :S] = vals

    _write_kv(cache["k"], k, write)
    _write_kv(cache["v"], v, write)
    cache["pos"][:, :S] = positions.to(torch.int32)
    return cache


def _cache_write_chunk(cache: dict, k, v, positions) -> dict:
    """Append one prefill chunk (positions [B, C], consecutive, the same
    for every row) to a ring or contiguous cache that holds the earlier
    chunks, in place, token p at slot ``p % cap``: C <= cap positions go
    to distinct slots (a chunk may start mid-ring); of a chunk longer than
    the ring only its last cap tokens are kept."""
    cap = cache["k"].shape[1]
    k, v, positions = k[:, -cap:], v[:, -cap:], positions[:, -cap:].to(torch.int32)
    slots = positions[0].long() % cap

    def write(buf, vals):
        buf[:, slots] = vals

    _write_kv(cache["k"], k, write)
    _write_kv(cache["v"], v, write)
    cache["pos"][:, slots] = positions
    return cache


def _cache_write_chunk_batched(cache: dict, k, v, positions) -> dict:
    """Each row's chunk (positions [B, C], -1 at padding) into its own ring,
    in place: a row keeps its last cap valid tokens at slots ``p % cap``.
    JAX drops the other entries (an out-of-bounds scatter); here each of
    them rewrites its row's last valid entry with that entry's own values,
    so the write is one scatter whose colliding entries carry equal values.
    A row with no valid entry writes garbage at slot ``-1 % cap``: only
    inactive rows have none, and the caller restores those."""
    cap = cache["k"].shape[1]
    B, C = positions.shape
    pos = positions.to(torch.int32)
    row_max = pos.amax(dim=1, keepdim=True)
    keep = (pos >= 0) & (pos > row_max - cap)
    last = (pos >= 0).sum(dim=1, keepdim=True).clamp_min(1) - 1  # each row's last valid entry
    src = torch.where(keep, torch.arange(C, device=pos.device)[None], last)  # [B, C]
    src_pos = pos.gather(1, src)
    slots = src_pos.long() % cap
    rows = torch.arange(B, device=pos.device)[:, None]

    def gathered(vals):
        return vals.gather(1, src.reshape(B, C, *([1] * (vals.ndim - 2))).expand(vals.shape))

    def write(buf, vals):
        buf[rows, slots] = vals

    _write_kv(cache["k"], gathered(k), write)
    _write_kv(cache["v"], gathered(v), write)
    cache["pos"][rows, slots] = src_pos
    return cache


def _cache_write_decode(cache: dict, k_new, v_new, index) -> dict:
    """Write one token per row at slot ``index % capacity`` (in place):
    ``index`` an int (uniform batch) or an int32 tensor [B] (ragged, each
    row at its own position)."""
    cap = cache["k"].shape[1]
    if isinstance(index, int):
        rows, slot, pos = slice(None), index % cap, index
    else:
        rows = torch.arange(index.shape[0], device=index.device)
        slot, pos = index.long() % cap, index.to(torch.int32)

    def write(buf, vals):
        buf[rows, slot] = vals[:, 0]

    _write_kv(cache["k"], k_new, write)
    _write_kv(cache["v"], v_new, write)
    cache["pos"][rows, slot] = pos
    return cache


def spec_is_paged(spec: AttnSpec) -> bool:
    """Whether a self-attention layer's cache goes into the shared page pool
    under paged serving: every layer but sliding-window ones, which keep
    per-slot rings beside the pool (a ring is already fixed-size)."""
    return not (spec.kind == "local" and spec.window > 0)


def init_paged_kv_cache(n_pages: int, page_size: int, n_kv: int, head_dim: int, dtype, device,
                        *, lead=(), kv_bits: int = 0) -> dict:
    """Shared page-pool KV cache ``[n_pages + 1, page_size, n_kv, head_dim]``,
    no batch axis: sequences own pages through per-slot block tables
    (``serving/kv_pool.py``).  The last page is the trash page: never handed
    out, its ``pos`` stays -1, unmapped table entries clamp to it on read and
    inactive rows write into it.  ``kv_bits=8``: int8 pages with
    per-(token, head) scales ``[..., n_pages + 1, page_size, n_kv, 1]``."""
    lead = tuple(lead)
    shape = lead + (n_pages + 1, page_size, n_kv, head_dim)
    return {
        "k": _kv_tensor(shape, dtype, device, kv_bits),
        "v": _kv_tensor(shape, dtype, device, kv_bits),
        "pos": torch.full(lead + (n_pages + 1, page_size), -1, dtype=torch.int32, device=device),
    }


def _paged_clamp_table(table: torch.Tensor, n_pages_total: int) -> torch.Tensor:
    """-1 (unmapped) entries -> the trash page, whose pos is pinned at -1.
    The model-level entry points clamp once per call; every function below
    takes the clamped int32 table and int32 positions."""
    return torch.where(table < 0, n_pages_total - 1, table).to(torch.int32)


def _paged_cache_write_decode(cache: dict, k_new, v_new, row_pos, table) -> dict:
    """Write one token per row into its block-table page (in place).  Rows
    whose entry is unmapped (inactive slots: all-trash table rows) land in the
    trash page with position -1; those writes may collide, and a plain
    (non-accumulating) index_put leaves the trash page's pos at -1 whatever
    the order."""
    Pt, ps = cache["pos"].shape
    B = row_pos.shape[0]
    rows = torch.arange(B, device=row_pos.device)
    pos = row_pos.long()
    pages = table[rows, pos // ps].long()
    offs = pos % ps

    def write(buf, vals):
        buf[pages, offs] = vals[:, 0]

    _write_kv(cache["k"], k_new, write)
    _write_kv(cache["v"], v_new, write)
    cache["pos"][pages, offs] = torch.where(pages == Pt - 1, -1, row_pos)
    return cache


def _paged_cache_write_chunk(cache: dict, k_new, v_new, positions, table_row) -> dict:
    """Write one prefill chunk's K/V (one sequence, C consecutive positions)
    straight into its block-table pages (in place).  Unmapped entries (the
    trash page) are written with position -1.  An entry that already holds the
    exact position being written can only be a prefix page shared from
    another admission (fresh and recycled pages carry -1), so that write is
    routed to the trash page too: ``already`` reads ``pos`` before the write,
    as the JAX function does."""
    Pt, ps = cache["pos"].shape
    pos = positions.long()  # [C]
    offs = pos % ps
    pages = table_row[pos // ps].long()
    already = cache["pos"][pages, offs] == positions
    pages = torch.where(already, Pt - 1, pages)

    def write(buf, vals):
        buf[pages, offs] = vals[0]

    _write_kv(cache["k"], k_new, write)
    _write_kv(cache["v"], v_new, write)
    cache["pos"][pages, offs] = torch.where(pages == Pt - 1, -1, positions)
    return cache


def _paged_cache_write_chunk_batched(cache: dict, k_new, v_new, positions, tables) -> dict:
    """Every row's chunk [B, C] written into its own block-table pages in one
    scatter (in place).  positions [B, C] hold -1 at padding and for an
    inactive row; those entries, unmapped ones, and shared-prefix entries
    that already hold the position (the ``already`` rule of
    ``_paged_cache_write_chunk``) go to the trash page with position -1.
    Distinct valid entries never collide: a page written this tick is not
    yet in the prefix index, so no other row's table holds it; the trash
    page's writes all carry -1, so their order does not matter."""
    Pt, ps = cache["pos"].shape
    valid = positions >= 0
    pos = positions.long().clamp_min(0)
    offs = pos % ps
    pages = tables.long().gather(1, pos // ps)
    already = cache["pos"][pages, offs] == positions
    pages = torch.where(already | ~valid, Pt - 1, pages)

    def write(buf, vals):
        buf[pages, offs] = vals

    _write_kv(cache["k"], k_new, write)
    _write_kv(cache["v"], v_new, write)
    cache["pos"][pages, offs] = torch.where(pages == Pt - 1, -1, positions)
    return cache


def _all_rows(*parts):
    """``parts`` (the new K/V, their positions and block table, each with a
    leading row dim) for every row of the ambient sharded step: the rank's
    rows' bytes gathered in one all-gather; as given outside such a step."""
    rows = get_rows()
    if rows is None:
        return parts
    b = parts[0].shape[0]
    flat = [t.contiguous().view(b, -1).view(torch.uint8) for t in parts]
    got = col.all_gather(torch.cat(flat, dim=1), rows.mesh, rows.axes)
    out, at = [], 0
    for t, f in zip(parts, flat):
        out.append(got[:, at:at + f.shape[1]].contiguous().view(t.dtype)
                   .view(rows.n, *t.shape[1:]))
        at += f.shape[1]
    return tuple(out)


def _kv_args(cache: dict) -> tuple:
    """(k, v, scales) of a cache for the paged kernels: the int8 tensors and
    ``dict(k_scale=, v_scale=)`` of a ``QuantizedKV`` pool, else the fp
    tensors and no scales."""
    k, v = cache["k"], cache["v"]
    if isinstance(k, QuantizedKV):
        return k.q, v.q, dict(k_scale=k.scale, v_scale=v.scale)
    return k, v, {}


def _plan_rows(B: int) -> int:
    """The row count kernels 7 and 9 plan their splits for: the whole step's
    in a sharded step (each row's sums as on one device), else B."""
    rows = get_rows()
    return rows.n if rows is not None and rows.rows == B else B


def _decode_attend_quant(q, cache: dict, row_pos, spec: AttnSpec, scale: float):
    """One-token decode over a contiguous int8 cache, through kernel 9.
    q: [B, 1, H, dh]; row_pos [B] int32."""
    B, _, H, dh = q.shape
    Hkv = cache["k"].shape[2]
    qg = q[:, 0].reshape(B, Hkv, H // Hkv, dh).contiguous()
    y = decode_attention_quant(
        qg, cache["k"].q, cache["k"].scale, cache["v"].q, cache["v"].scale, cache["pos"], row_pos,
        scale=scale, causal=spec.causal, window=_window(spec), softcap=spec.logit_softcap,
        plan_rows=_plan_rows(B))
    return y.reshape(B, 1, H, dh)


def _paged_decode_attend(q, cache: dict, row_pos, table, spec: AttnSpec, scale: float):
    """One-token decode over a paged pool, through kernel 7 (its int8 branch
    over an int8 pool).  q: [B, 1, H, dh]."""
    B, _, H, dh = q.shape
    Hkv = cache["k"].shape[2]
    # head h is kv * G + g: the [H] -> [Hkv, G] reshape, not a transpose
    qg = q[:, 0].reshape(B, Hkv, H // Hkv, dh).contiguous()
    k, v, scales = _kv_args(cache)
    y = paged_decode_attention(
        qg, k, v, cache["pos"], table, row_pos,
        scale=scale, causal=spec.causal, window=_window(spec),
        softcap=spec.logit_softcap, plan_rows=_plan_rows(B), **scales)
    return y.reshape(B, 1, H, dh)


def _paged_prefill_chunk_attend(q, k, v, cache: dict, positions, table_row, spec: AttnSpec,
                                scale: float):
    """Chunk queries attend over (the pool's pages, BEFORE this chunk's
    write) ++ (the chunk's own fp K/V, causal), through kernel 8 (its int8
    branch over an int8 pool).  q/k/v: [1, C, ...]; positions [C]."""
    _, C, H, dh = q.shape
    Hkv = k.shape[2]
    pk, pv, scales = _kv_args(cache)
    y = paged_prefill_attention(
        q[0].reshape(C, Hkv, H // Hkv, dh).contiguous(), pk, pv, cache["pos"],
        table_row, positions, k[0].contiguous(), v[0].contiguous(),
        scale=scale, causal=spec.causal, window=_window(spec),
        softcap=spec.logit_softcap, **scales)
    return y.reshape(1, C, H, dh)


def _paged_prefill_chunk_attend_batched(q, k, v, cache: dict, positions, tables, spec: AttnSpec,
                                        scale: float):
    """Every row's chunk attends over its own pages (BEFORE this call's
    writes; pool keys at positions >= the row's chunk start masked) plus its
    own fp K/V, causal, in ONE launch of the batched kernel 8 (its int8
    branch over an int8 pool).  q/k/v: [B, C, ...]; positions [B, C] with -1
    at padding; a padded query gives 0."""
    B, C, H, dh = q.shape
    Hkv = k.shape[2]
    pk, pv, scales = _kv_args(cache)
    y = paged_prefill_attention_batched(
        q.reshape(B, C, Hkv, H // Hkv, dh).contiguous(), pk, pv, cache["pos"], tables,
        positions, k.contiguous(), v.contiguous(), scale=scale, causal=spec.causal,
        window=_window(spec), softcap=spec.logit_softcap, **scales)
    return y.reshape(B, C, H, dh)


# ---------------------------------------------------------------------------
# Core scaled-dot-product with GQA + masking
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask, scale: float, cap: float):
    """q: [B,S,H,dh], k/v: [B,T,Hkv,dh], mask: [B,1,1,S,T] or broadcastable.
    Returns [B,S,H,dh].  Logits and softmax in f32."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    logits = logits * scale
    logits = softcap(logits, cap)
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, dh)


def _window_causal_mask(q_pos, k_pos, window: int, causal: bool):
    """q_pos: [B,S] or [S]; k_pos: [B,T] or [T] -> bool [B,1,1,S,T]."""
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    if k_pos.ndim == 1:
        k_pos = k_pos[None]
    q = q_pos[:, :, None]
    k = k_pos[:, None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window > 0:
        m = m & (q - k < window)
    return m[:, None, None]


def attend_full(q, k, v, q_pos, k_pos, spec: AttnSpec, scale: float):
    """q: [B,S,H,dh], k/v: [B,T,Hkv,dh], positions [B,S] / [B,T] or [S] /
    [T] -> [B,S,H,dh], through kernel 6 (its plain version on the CPU, which
    attends 1024 queries at a time).  Masked entries get probability
    0: a row with no valid key gives 0, where the JAX ``_sdpa`` averages."""
    B, S = q.shape[:2]
    T = k.shape[1]
    q_pos = (q_pos if q_pos.ndim == 2 else q_pos[None]).expand(B, S).to(torch.int32).contiguous()
    k_pos = (k_pos if k_pos.ndim == 2 else k_pos[None]).expand(B, T).to(torch.int32).contiguous()
    return flash_attention_gqa(
        q.contiguous(), k.contiguous(), v.contiguous(), q_pos, k_pos, scale=scale,
        causal=spec.causal, window=_window(spec),
        softcap=spec.logit_softcap)


# The JAX ``attend_chunked`` attends ``q_chunk`` queries at a time; its
# result equals ``attend_full`` row for row.  Kernel 6 tiles the queries
# itself and its plain version chunks them, so here the two are one.
attend_chunked = attend_full


# ---------------------------------------------------------------------------
# Layer-level apply
# ---------------------------------------------------------------------------


def _proj(x, w):
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d = w.shape[0]
    return (x @ w.reshape(d, -1)).view(*x.shape[:-1], *w.shape[1:])


def _cross_attention(cfg: ModelConfig, spec: AttnSpec, params: dict, x: torch.Tensor,
                     memory: Optional[torch.Tensor], cache: Optional[dict], mode: str):
    """The ``cross`` kind: queries of x [B, S, d] over the encoder memory [B,
    T, d], no causal mask, no RoPE (JAX ``attention``'s cross branch).  A
    decode mode reads the cross cache; every other mode projects K/V from
    ``memory``, attends through kernel 6 (query positions 0, key positions
    0 .. T - 1, non-causal) and, in a prefill mode, writes the cache's
    first T entries (a chunk rewrites the same values)."""
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q = _proj(x, materialize(params["wq"]))
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rms_eps)
    if cache is not None and mode.startswith("decode"):
        q_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
        mask = _window_causal_mask(q_pos, cache["pos"], 0, causal=False)
        y = _sdpa(q, cache["k"], cache["v"], mask, scale, spec.logit_softcap)
    else:
        if memory is None:
            raise ValueError("cross attention needs the encoder memory outside a decode step")
        mem = memory.to(x.dtype)
        k = _proj(mem, materialize(params["wk"]))
        v = _proj(mem, materialize(params["wv"]))
        if spec.qk_norm:
            k = rmsnorm(params["k_norm"], k, cfg.rms_eps)
        T = k.shape[1]
        k_pos = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
        q_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
        y = attend_full(q, k, v, q_pos, k_pos, spec, scale)
        if cache is not None and mode in ("prefill", "prefill_chunk", "prefill_chunk_batched"):
            if T > cache["k"].shape[1]:
                raise ValueError(f"cross attention: a memory of {T} positions for a cross cache "
                                 f"of {cache['k'].shape[1]}")
            cache["k"][:, :T] = k.to(cache["k"].dtype)
            cache["v"][:, :T] = v.to(cache["v"].dtype)
            cache["pos"][:, :T] = k_pos
    wo = materialize(params["wo"])
    H, dh, d = wo.shape
    return y.reshape(B, S, H * dh) @ wo.reshape(H * dh, d), cache


def attention(
    cfg: ModelConfig,
    spec: AttnSpec,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[dict] = None,
    mode: str = "train",
    index: Optional[int] = None,
    block_table: Optional[torch.Tensor] = None,
    memory: Optional[torch.Tensor] = None,
):
    """Returns (y, cache).  mode: train | prefill | decode | decode_ragged |
    decode_paged | prefill_chunk | prefill_chunk_batched.

    - train:   causal self-attention over x, no cache IO (kernel 6).
    - prefill: the same, and writes the cache (in place).
    - decode:  x is [B, 1, d]; writes the token at slot ``index`` (the
               uniform batch position), then attends over the cache.
    - decode_ragged: the same at per-row ``positions`` [B, 1] (contiguous
               continuous batching; kernel 9 over an int8 cache).
    - decode_paged: x is [B, 1, d] at per-row ``positions`` [B, 1]; the
               cache is a page pool addressed through ``block_table``
               [B, max_pages] (int32, clamped); writes each row's token into its page, then
               attends (kernel 7).
    - prefill_chunk: x is [1, C, d], one chunk of one sequence at absolute
               ``positions``; attends over the pool's pages named by
               ``block_table`` (its earlier chunks) plus the chunk itself
               (kernel 8), then writes the chunk's K/V into its pages.
    - prefill_chunk_batched: x is [B, C, d], one chunk per row at
               ``positions`` [B, C] (-1 at padding), ``block_table`` [B,
               max_pages] (an inactive row's all trash); every row attends
               in one launch of the batched kernel 8, then the chunks are
               written.

    A sliding-window layer keeps its per-slot ring in the paged modes: a
    paged decode is a ragged decode of the ring, and a chunk resumes it
    (``_sdpa`` over ``cat(ring, chunk)``, then the ring write).  A ``cross``
    layer attends over ``memory`` (``_cross_attention``).
    """
    check_spec(spec)
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    if spec.kind == "cross":
        return _cross_attention(cfg, spec, params, x, memory, cache, mode)
    paged = mode in PAGED_MODES and spec_is_paged(spec)
    if paged and block_table is None:
        raise ValueError(f"attention: {mode} of a paged layer needs a block table")
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)

    # materialize: dequantizes MoQ-quantized projections, passes fp ones through
    q = _proj(x, materialize(params["wq"]))
    k = _proj(x, materialize(params["wk"]))
    v = _proj(x, materialize(params["wv"]))
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rms_eps)
        k = rmsnorm(params["k_norm"], k, cfg.rms_eps)
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)

    if mode in ("prefill_chunk", "prefill_chunk_batched") and not paged:
        # a ring (or contiguous cache) resumed: the earlier chunks are in the
        # cache, read before this chunk is written; per row in both modes
        pos2d = positions.expand(B, S).to(torch.int32)
        kcat = torch.cat([materialize_kv(cache["k"]).to(k.dtype), k], dim=1)
        vcat = torch.cat([materialize_kv(cache["v"]).to(v.dtype), v], dim=1)
        k_pos = torch.cat([cache["pos"], pos2d], dim=1)
        mask = _window_causal_mask(pos2d, k_pos, _window(spec), spec.causal)
        y = _sdpa(q, kcat, vcat, mask, scale, spec.logit_softcap)
        if mode == "prefill_chunk_batched":
            cache = _cache_write_chunk_batched(cache, k, v, pos2d)
        else:
            cache = _cache_write_chunk(cache, k, v, pos2d)
    elif mode == "prefill_chunk":
        pos1d = positions.reshape(-1)
        table_row = block_table[0] if block_table.ndim == 2 else block_table
        y = _paged_prefill_chunk_attend(q, k, v, cache, pos1d, table_row, spec, scale)
        cache = _paged_cache_write_chunk(cache, k, v, pos1d, table_row)
    elif mode == "prefill_chunk_batched":
        pos2d = positions.expand(B, S).contiguous()
        y = _paged_prefill_chunk_attend_batched(q, k, v, cache, pos2d, block_table, spec, scale)
        cache = _paged_cache_write_chunk_batched(cache, *_all_rows(k, v, pos2d, block_table))
    elif mode == "decode_paged" and paged:
        row_pos = positions.reshape(B)
        cache = _paged_cache_write_decode(cache, *_all_rows(k, v, row_pos, block_table))
        y = _paged_decode_attend(q, cache, row_pos, block_table, spec, scale)
    elif mode in ("decode", "decode_ragged", "decode_paged"):
        assert cache is not None and S == 1
        if mode == "decode":
            assert index is not None
            row_pos = torch.full((B,), index, dtype=torch.int32, device=x.device)
            cache = _cache_write_decode(cache, k, v, index)
        else:
            row_pos = positions.reshape(B)
            cache = _cache_write_decode(cache, k, v, row_pos)
        if isinstance(cache["k"], QuantizedKV):
            # the just-written token is read back quantized too, as the
            # kernel streams it
            y = _decode_attend_quant(q, cache, row_pos, spec, scale)
        else:
            mask = _window_causal_mask(row_pos[:, None], cache["pos"], _window(spec), spec.causal)
            y = _sdpa(q, cache["k"], cache["v"], mask, scale, spec.logit_softcap)
    else:
        pos2d = positions if positions.ndim == 2 else positions[None]
        pos2d = pos2d.expand(B, S)
        y = attend_chunked(q, k, v, pos2d, pos2d, spec, scale)
        if mode == "prefill" and cache is not None:
            cache = _cache_write_prefill(cache, k, v, pos2d)

    wo = materialize(params["wo"])
    H, dh, d = wo.shape
    out = (y.reshape(B, S, H * dh) @ wo.reshape(H * dh, d))
    return out, cache
