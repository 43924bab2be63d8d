"""Per-step accounting over an op capture (``analysis/graph.py``): the
port's counterpart of ``repro/launch/hlo_account.py``, which totals a
compiled XLA graph from its HLO text.

For one step, ``account(capture)`` sums:

  * operations — ``2·M·N·K`` over every matmul the step runs as aten ops
    (``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``linear``), plus each
    kernel entry's operations by the formula of PERF.md §3 "Bounds"
    (``KERNELS``, one function per kernel, from the entry's own arguments:
    the positions, tables and fills of this run's data);
  * traffic bytes — operands plus outputs of every other aten op that
    moves data (views and allocations excepted), plus each kernel entry's
    bytes by the same formulas.  A gather (``index``, ``index_select``,
    ``embedding``, ``gather``) reads only the rows it selects: its indices,
    and its output read and written once each, not its whole source (an
    embedding lookup of 4 tokens reads 4 rows of the table).  An in-place
    scatter (``index_put_``, ``index_add_``, ``scatter_`` ...) writes only
    the rows its values name: its indices and values read, those rows
    written (and read as well when it adds).  A functional scatter copies
    its whole source into a new tensor, and is counted whole;
  * collective bytes and counts by kind (the collectives' inputs).

Bits per element as JAX's ``_DTYPE_BITS``: an int4 tensor packs two values
in a byte, so its stored buffer already counts half a byte a value, and
bytes are rounded up per buffer.  The bound of the step is then the larger
of its operations over the card's peak for their type and its bytes over
the memory rate (``launch/roofline.py``).  The kernels 4 / 4b entries do
not carry T·K, so their operations count the rows of their live tiles
(padding rows included): at most one tile per expert above the routed
rows.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from repro_torch.analysis.graph import Capture, OpRecord, QuantMeta, TensorMeta

_DTYPE_BITS = {
    torch.float64: 64, torch.float32: 32, torch.float16: 16, torch.bfloat16: 16,
    torch.int64: 64, torch.int32: 32, torch.int16: 16, torch.int8: 8, torch.uint8: 8,
    torch.bool: 8, torch.complex64: 64,
}
TILE = 8  # the grouped layout's rows a tile (core/dispatch_grouped.py)

_MATMUL = {"aten.mm.default", "aten.bmm.default", "aten.addmm.default",
           "aten.baddbmm.default", "aten.linear.default"}
# ops that move no data: views, metadata, allocations
_FREE = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand", "unsqueeze",
         "squeeze", "select", "slice", "as_strided", "alias", "split", "split_with_sizes",
         "unbind", "chunk", "detach", "empty", "empty_strided", "empty_like", "lift_fresh",
         "_reshape_alias", "unflatten", "flatten", "movedim", "narrow", "view_as_real",
         "view_as_complex", "_local_scalar_dense", "is_same_size", "sym_size", "sym_stride",
         "diagonal", "unfold", "set_", "resize_", "_has_compatible_shallow_copy_type"}
# ops that read the rows their indices select: (source, *indices) -> rows
_GATHER = {"index", "_unsafe_index", "index_select", "embedding", "gather", "take",
           "take_along_dim"}
# in-place ops that write the rows their indices select: (target, *indices,
# values), the value of each ``True`` whether it also reads those rows
_SCATTER = {"index_put_": False, "_index_put_impl_": False, "index_copy_": False,
            "scatter_": False, "masked_scatter_": False, "index_add_": True,
            "scatter_add_": True, "scatter_reduce_": True}


def buffer_bytes(dtype: torch.dtype, n_elems: int) -> int:
    return (n_elems * _DTYPE_BITS.get(dtype, 32) + 7) // 8


def meta_bytes(m) -> int:
    if isinstance(m, TensorMeta):
        return buffer_bytes(m.dtype, m.numel)
    if isinstance(m, QuantMeta):
        return meta_bytes(m.q) + meta_bytes(m.scale)
    return 0


@dataclass
class Account:
    ops: float = 0.0  # every operation the step does: matmuls + kernel formulas
    ops_by_dtype: Dict[str, float] = field(default_factory=dict)
    matmul_ops: float = 0.0  # 2MNK over the aten matmuls alone
    traffic: float = 0.0  # bytes
    kernel_bytes: Dict[str, float] = field(default_factory=dict)
    kernel_count: Dict[str, int] = field(default_factory=dict)
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, int] = field(default_factory=dict)

    def add_ops(self, ops: float, dtype: torch.dtype) -> None:
        self.ops += ops
        k = str(dtype).replace("torch.", "")
        self.ops_by_dtype[k] = self.ops_by_dtype.get(k, 0.0) + ops


# ---------------------------------------------------------------------------
# The kernels' formulas (PERF.md §3 "Bounds"): (bytes, operations, dtype)
# ---------------------------------------------------------------------------


def _val(m) -> torch.Tensor:
    if not isinstance(m, TensorMeta) or m.value is None:
        raise ValueError("op_account: an entry's integer argument was not kept")
    return m.value.long()


def _es(m: TensorMeta) -> int:
    return _DTYPE_BITS[m.dtype] // 8


def _expert_bytes(a) -> int:
    """One expert's wi, wg and wo: values in their type, or int8 / packed
    int4 values plus their f32 column scales."""
    total = 0
    for n in ("wi", "wg", "wo"):
        w = a[n]
        if isinstance(w, QuantMeta):
            total += math.prod(w.q.shape[1:]) + math.prod(w.scale.shape[1:]) * 4
        else:
            total += math.prod(w.shape[1:]) * _es(w)
    return total


def _expert_dims(a) -> Tuple[int, int, int]:
    E, D, F = a["wi"].shape
    return E, D, F


def gating(a) -> tuple:
    """Kernel 1: the logits in, probs and the [T, K] outputs and the counts
    out; softmax and K masked argmaxes a row as f32 operations."""
    T, E = a["logits"].shape
    K = a["top_k"]
    return 2 * T * E * 4 + T * K * (4 + 4 + 4 + 1) + E * 4, T * E * (4 + 2 * K), torch.float32


def gating_backward(a) -> tuple:
    """Kernel 1b: probs, dprobs and dlogits (f32) and its [T, K] inputs."""
    T, E = a["probs"].shape
    K = a["expert_idx"].shape[1]
    return 3 * 4 * T * E + 9 * T * K, 0, torch.float32


def capacity_mlp(a) -> tuple:
    """Kernels 2, 3: the weights of the experts with tokens, the kept input
    rows, the whole [E, C, D] output and the fill; 2·kept·3·D·F."""
    xe = a["xe"]
    E, D, F = _expert_dims(a)
    C = xe.shape[1]
    fill = a.get("fill")
    if isinstance(fill, TensorMeta):
        f = _val(fill).clamp(0, C)
        kept, live = int(f.sum()), int((f > 0).sum())
    else:
        kept, live = E * C, E
    need = live * _expert_bytes(a) + (kept + E * C) * D * _es(xe) + E * 4
    return need, 2 * kept * 3 * D * F, xe.dtype


def _grouped_live(a) -> Tuple[int, int]:
    used = int(_val(a["rows_used"]).reshape(-1)[0])
    te = _val(a["te"])[: used // TILE]
    return used, int(torch.unique(te).numel())


def grouped_mlp(a) -> tuple:
    """Kernels 4, 5: the weights of the experts the live tiles touch, the
    live input rows, the whole [Ct, D] output and the tile entries;
    2·rows·3·D·F over the live tiles' rows."""
    xg = a["xg"]
    E, D, F = _expert_dims(a)
    Ct = xg.shape[0]
    used, n_exp = _grouped_live(a)
    need = n_exp * _expert_bytes(a) + (used + Ct) * D * _es(xg) + (used // TILE + 1) * 4
    return need, 2 * used * 3 * D * F, xg.dtype


def _mlp_backward(a, x, live_e, kept) -> tuple:
    E, D, F = _expert_dims(a)
    b = _es(x)
    need = live_e * 3 * D * F * b + 3 * E * D * F * b + 2 * kept * D * b + x.numel * b
    return need, 16 * kept * D * F, x.dtype


def expert_mlp_backward(a) -> tuple:
    """Kernel 2b: the live experts' weights read, every weight gradient and
    dx written, x and dy of the kept rows; 16·kept·D·F."""
    xe = a["xe"]
    E, C = xe.shape[:2]
    fill = a.get("fill")
    if isinstance(fill, TensorMeta):
        f = _val(fill).clamp(0, C)
        kept, live = int(f.sum()), int((f > 0).sum())
    else:
        kept, live = E * C, E
    return _mlp_backward(a, xe, live, kept)


def grouped_mlp_backward(a) -> tuple:
    """Kernel 4b: as 2b over the live tiles' rows."""
    used, n_exp = _grouped_live(a)
    return _mlp_backward(a, a["xg"], n_exp, used)


def _pairs(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int,
           chunk: int = 1024) -> int:
    """Unmasked (query, key) pairs of one head, over query chunks."""
    n = 0
    kp = k_pos[:, None, :]
    for s0 in range(0, q_pos.shape[1], chunk):
        qp = q_pos[:, s0:s0 + chunk, None]
        valid = (kp >= 0).expand(-1, qp.shape[1], -1)
        if causal:
            valid = valid & (kp <= qp)
        if window > 0:
            valid = valid & (qp - kp < window)
        n += int(valid.sum())
    return n


def flash_attention(a) -> tuple:
    """Kernel 6: q, k, v and out once each and both position rows;
    4·H·dh per unmasked (query, key) pair."""
    q, k = a["q"], a["k"]
    B, S, H, dh = q.shape
    pairs = _pairs(_val(a["q_pos"]), _val(a["k_pos"]), a["causal"], a["window"])
    need = (2 * q.numel + 2 * k.numel) * _es(q) + (a["q_pos"].numel + a["k_pos"].numel) * 4
    return need, 4 * H * dh * pairs, q.dtype


def flash_attention_backward(a) -> tuple:
    """Kernel 6b: q, k, v, O, dO, dQ, dK, dV, L and the positions;
    10·dh per unmasked pair and head."""
    q, k = a["q"], a["k"]
    B, S, H, dh = q.shape
    pairs = _pairs(_val(a["q_pos"]), _val(a["k_pos"]), a["causal"], a["window"])
    need = (_es(q) * (4 * q.numel + 4 * k.numel) + 4 * a["lse"].numel
            + 4 * (a["q_pos"].numel + a["k_pos"].numel))
    return need, 10 * dh * pairs * H, q.dtype


def _key_bytes(pool: TensorMeta) -> int:
    """One key (or value) of one kv-head: dh values, plus an f32 scale in
    an int8 pool."""
    dh = pool.shape[-1]
    return dh + 4 if pool.dtype == torch.int8 else dh * _es(pool)


def _paged_bytes(pool: TensorMeta, kpos: torch.Tensor, table: torch.Tensor,
                 needed: torch.Tensor) -> int:
    """The positions of every live (non-trash) table entry, and K and V of
    the keys attended to (each once)."""
    Pt, ps, Hkv, _ = pool.shape
    live = table != Pt - 1
    slots = table[..., None] * ps + torch.arange(ps)
    keys = int(torch.unique(slots[needed & live[..., None]]).numel())
    return int(live.sum()) * ps * 4 + keys * 2 * Hkv * _key_bytes(pool)


def _mask(kp, qp, causal, window):
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (qp - kp < window)
    return m


def paged_decode(a) -> tuple:
    """Kernels 7, 7q: the live entries' positions, the K/V attended to, q,
    out, the table and qpos; 4·H·dh per unmasked (query, key)."""
    q, pool = a["q"], a["k_pool"]
    B, Hkv, G, dh = q.shape
    kpos, table, qpos = _val(a["kpos"]), _val(a["table"]), _val(a["qpos"]).reshape(-1)
    kp = kpos[table]  # [B, nt, ps]
    needed = _mask(kp, qpos[:, None, None], a["causal"], a["window"])
    pairs = int(needed.sum())
    need = (_paged_bytes(pool, kpos, table, needed) + 2 * q.numel * _es(q)
            + table.numel() * 4 + B * 4)
    return need, 4 * Hkv * G * dh * pairs, q.dtype


def _prefill_row(pool, kpos, table, qpos, causal, window) -> Tuple[int, int]:
    """(pool bytes, pairs) of one chunk: history keys below its first query,
    then the chunk's own keys."""
    valid_q = qpos[qpos >= 0]
    if valid_q.numel() == 0:
        return 0, 0
    kp = kpos[table]  # [nt, ps]
    hist = (kp >= 0) & (kp < valid_q.min())
    hk = kp[hist]
    pairs = int(_mask(hk[None, :], valid_q[:, None], causal, window).sum())
    pairs += int(_mask(valid_q[None, :], valid_q[:, None], causal, window).sum())
    return _paged_bytes(pool, kpos, table, hist), pairs


def paged_prefill(a) -> tuple:
    """Kernels 8, 8q: the pool bytes as 7's over the history, q, out, ck,
    cv, the table and qpos; 4·H·dh per unmasked pair."""
    q, pool = a["q"], a["k_pool"]
    C, Hkv, G, dh = q.shape
    pb, pairs = _prefill_row(pool, _val(a["kpos"]), _val(a["table"]), _val(a["qpos"]),
                             a["causal"], a["window"])
    need = pb + (2 * q.numel + 2 * a["ck"].numel) * _es(q) + a["table"].numel * 4 + C * 4
    return need, 4 * Hkv * G * dh * pairs, q.dtype


def paged_prefill_batched(a) -> tuple:
    """The batched kernel 8 / 8q: 8's bytes and pairs summed over rows."""
    q, pool = a["q"], a["k_pool"]
    B, C, Hkv, G, dh = q.shape
    kpos, tables, qpos = _val(a["kpos"]), _val(a["tables"]), _val(a["qpos"])
    pb = pairs = 0
    for r in range(B):
        b_, p_ = _prefill_row(pool, kpos, tables[r], qpos[r], a["causal"], a["window"])
        pb, pairs = pb + b_, pairs + p_
    need = pb + (2 * q.numel + 2 * a["ck"].numel) * _es(q) + a["tables"].numel * 4 + B * C * 4
    return need, 4 * Hkv * G * dh * pairs, q.dtype


def decode_quant(a) -> tuple:
    """Kernel 9: K/V of the keys attended to, the positions, q, out, qpos;
    4·H·dh per key attended to."""
    q, kq = a["q"], a["kq"]
    B, Hkv, G, dh = q.shape
    kpos, qpos = _val(a["kpos"]), _val(a["qpos"]).reshape(-1)
    keys = int(_mask(kpos, qpos[:, None], a["causal"], a["window"]).sum())
    need = keys * 2 * Hkv * _key_bytes(kq) + kpos.numel() * 4 + 2 * q.numel * _es(q) + B * 4
    return need, 4 * Hkv * G * dh * keys, q.dtype


KERNELS = {
    "moe_gating": gating,
    "moe_gating_backward": gating_backward,
    "expert_mlp": capacity_mlp,
    "expert_mlp_quant": capacity_mlp,
    "expert_mlp_backward": expert_mlp_backward,
    "grouped_mlp": grouped_mlp,
    "grouped_mlp_quant": grouped_mlp,
    "grouped_mlp_backward": grouped_mlp_backward,
    "flash_attention": flash_attention,
    "flash_attention_backward": flash_attention_backward,
    "paged_decode_attention": paged_decode,
    "paged_decode_attention_int8": paged_decode,
    "paged_prefill_attention": paged_prefill,
    "paged_prefill_attention_int8": paged_prefill,
    "paged_prefill_attention_batched": paged_prefill_batched,
    "paged_prefill_attention_batched_int8": paged_prefill_batched,
    "decode_attention_quant": decode_quant,
}


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _matmul_ops(r: OpRecord) -> float:
    """2·M·N·K of one matmul: the output's elements times the contraction."""
    out = r.outputs[0]
    lhs = r.inputs[1] if r.name in ("aten.addmm.default", "aten.baddbmm.default") else r.inputs[0]
    return 2.0 * out.numel * lhs.shape[-1]


def _op_base(name: str) -> str:
    return name.split(".")[1] if name.startswith("aten.") else name


def _aten_bytes(r: OpRecord) -> float:
    """The bytes one aten op moves (the module docstring)."""
    base = _op_base(r.name)
    if base in _GATHER:
        return (sum(meta_bytes(m) for m in r.inputs[1:])
                + 2 * sum(meta_bytes(m) for m in r.outputs))
    if base in _SCATTER and len(r.inputs) >= 2:
        target, values = r.inputs[0], r.inputs[-1]
        rows = buffer_bytes(target.dtype, values.numel) * (2 if _SCATTER[base] else 1)
        return sum(meta_bytes(m) for m in r.inputs[1:]) + rows
    return sum(meta_bytes(m) for m in r.inputs + r.outputs)


def account(cap: Capture) -> Account:
    acct = Account()
    for r in cap.records:
        if r.kind == "kernel":
            nbytes, ops, dtype = KERNELS[r.name](r.args)
            acct.traffic += nbytes
            acct.add_ops(ops, dtype)
            acct.kernel_bytes[r.name] = acct.kernel_bytes.get(r.name, 0.0) + nbytes
            acct.kernel_count[r.name] = acct.kernel_count.get(r.name, 0) + 1
        elif r.kind in ("collective", "c10d"):
            nbytes = sum(meta_bytes(m) for m in r.inputs[:1])
            acct.coll_bytes[r.name] = acct.coll_bytes.get(r.name, 0.0) + nbytes
            acct.coll_count[r.name] = acct.coll_count.get(r.name, 0) + 1
        elif r.name in _MATMUL:
            ops = _matmul_ops(r)
            acct.matmul_ops += ops
            acct.add_ops(ops, r.outputs[0].dtype)
            acct.traffic += sum(meta_bytes(m) for m in r.inputs + r.outputs)
        elif _op_base(r.name) not in _FREE:
            acct.traffic += _aten_bytes(r)
    return acct

