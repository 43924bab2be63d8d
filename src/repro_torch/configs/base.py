"""Config dataclasses for the repro framework.

A model is described structurally as a sequence of *segments*; each segment is a
``(pattern, repeats)`` pair where ``pattern`` is a tuple of :class:`LayerSpec`.
Segments are executed with ``jax.lax.scan`` over ``repeats`` (params stacked on a
leading axis), which keeps the lowered HLO size proportional to the number of
*unique* layer kinds rather than the depth.  This is also exactly the structure
needed for DeepSpeed-MoE's PR-MoE (pyramid = segments with growing expert counts,
each trained/served with its own expert-parallel degree).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Mixer specs (the sequence-mixing half of a block)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnSpec:
    """Multi-head (GQA) attention.

    kind: "global" (full causal), "local" (sliding window), "cross"
          (encoder-decoder cross attention; not causal, attends to memory).
    """

    kind: str = "global"
    window: int = 0  # sliding-window size for kind == "local"
    rope_theta: float = 10_000.0
    use_rope: bool = True
    causal: bool = True
    logit_softcap: float = 0.0  # gemma-style soft capping, 0 = off
    qk_norm: bool = False


@dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060]."""

    kind: str = "ssm"
    d_inner: int = 0  # typically 2 * d_model
    head_dim: int = 64
    state_dim: int = 128
    conv_dim: int = 4
    chunk: int = 256
    n_groups: int = 1

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclass(frozen=True)
class LRUSpec:
    """RG-LRU recurrence (RecurrentGemma / Griffin) [arXiv:2402.19427]."""

    kind: str = "lru"
    lru_width: int = 0
    conv_dim: int = 4
    num_heads: int = 1  # block-diagonal input/forget gates


# ---------------------------------------------------------------------------
# FFN specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FFNSpec:
    """Feed-forward half of a block.

    kind: "dense"  — a single (Swi)GLU/GELU MLP.
          "moe"    — top-k gated mixture of experts (DeepSpeed-MoE §3).
          "none"   — no FFN (mamba2 blocks are mixer-only).
    residual: if True, adds a fixed dense MLP branch alongside the routed
          expert(s) — the paper's Residual-MoE (§4.1.1, Phenomenon-II); also
          models "shared expert" architectures (llama4, kimi-k2).
    """

    kind: str = "dense"
    d_ff: int = 0
    act: str = "swiglu"  # "swiglu" | "gelu" | "relu"
    # --- MoE fields ---
    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    residual: bool = False
    residual_d_ff: int = 0  # dense branch width (defaults to d_ff)
    aux_loss_coef: float = 0.01  # Table 1: "MoE loss coefficient"


@dataclass(frozen=True)
class QuantConfig:
    """Weight-only PTQ recipe (MoQ, paper §4; see ``repro/quant``).

    bits:       8 or 4 (int4 packed two nibbles per byte).
    group_size: contraction inputs sharing one scale (0 = one scale per
                output channel); must divide the contraction dim (and be
                even for int4).  Applies to both int8 and int4; leaves with
                two contraction axes (attention out-proj) always use
                per-output-channel scales.
    policy:     which matmul weights to quantize —
                "experts"       routed expert mats only (the ~3.7x win:
                                experts are >90% of MoE params),
                "experts_attn"  + attention projections,
                "all"           every matmul weight (router/norms stay fp).
    kv_cache_bits: serving-time KV-cache quantization — 0 (fp, default) or
                8 (int8 with per-head, per-timestep f32 scales; see
                repro/quant/kv.py).  Orthogonal to the weight policy: the
                cache is activation state, quantized on write during
                prefill/decode, not by quantize_params.  Engines read this
                knob when allocating caches (EngineConfig.kv_cache_bits /
                ContinuousEngine(kv_cache_bits=...)).
    """

    bits: int = 8
    group_size: int = 0
    policy: str = "experts"
    kv_cache_bits: int = 0


@dataclass(frozen=True)
class PagedKVConfig:
    """Paged KV-cache serving (§5 memory economics; see ``serving/kv_pool.py``).

    Instead of reserving a contiguous ``capacity``-token cache row per slot,
    cache memory is a shared pool of fixed-size pages and each sequence owns
    only the pages its tokens occupy, through a static-shape block table.
    Effective concurrent sequences per cache byte then scale with the *actual*
    average sequence length rather than the worst case, and compose with
    ``kv_cache_bits=8`` (int8 pages).

    page_size: cache tokens per page.  Smaller pages pack tighter (≤
               ``page_size - 1`` tokens wasted per sequence) but mean more
               gather steps per decode; 16-128 is the practical range.
    n_pages:   total pages in the pool.  0 = auto-size to
               ``slots * ceil(capacity / page_size)`` (no oversubscription —
               same worst-case bytes as contiguous).  Provisioning fewer
               pages than the worst case is the point: admission goes by
               free-block count and the scheduler preempts the youngest slot
               if traffic outruns the pool.
    prefix_sharing: refcounted copy-on-write page sharing
               (serving/prefix_index.py): admissions whose context repeats an
               indexed full-page prefix (shared system prompts, few-shot
               preambles) point their block table at the existing physical
               pages instead of allocating and re-writing them, and parallel
               samples (``ContinuousEngine.submit_n`` / serve.py
               ``--n-samples``) share ALL prompt pages, diverging via
               copy-on-write.  Greedy outputs are token-identical to the
               non-shared paged engine; the win is pages — a prefix shared by
               N sequences costs 1/N of the pages per sequence.  Under
               chunked prefill the shared prefix's K/V is also read in place
               instead of recomputed, so sharing saves prefill FLOPs too
               (saved fraction = prefix_len / prompt_len).
    prefill_chunk: tokens of admission-prefill compute per engine tick
               (chunked prefill-into-pages; 0 = auto: max(64, page_size)).
               Admission still reserves all the prompt's pages up front
               (all-or-nothing, free-block admission unchanged), but the
               compute is spread one page-aligned chunk per ``step()``,
               interleaved with decode — a long prompt can never stall
               running decodes for more than one chunk of compute, and the
               temp contiguous prefill buffer of the old scatter path is
               gone.  Must be >= page_size.
    """

    page_size: int = 16
    n_pages: int = 0
    prefix_sharing: bool = False
    prefill_chunk: int = 0


@dataclass(frozen=True)
class LayerSpec:
    mixer: object  # AttnSpec | SSMSpec | LRUSpec
    ffn: FFNSpec
    # Optional cross-attention sub-block (decoder layers of enc-dec models):
    # runs self-attn (mixer) -> cross-attn -> ffn.
    cross: Optional["AttnSpec"] = None


@dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder models (seamless-m4t)."""

    segments: Tuple[Segment, ...]
    max_source_len: int = 4096


@dataclass(frozen=True)
class FrontendSpec:
    """Stubbed modality frontend: ``input_specs`` provides precomputed
    embeddings of shape [batch, n_tokens, embed_dim] (assignment carve-out)."""

    kind: str  # "audio" | "vision"
    n_tokens: int = 256
    embed_dim: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    source: str  # citation bracket from the assignment
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    segments: Tuple[Segment, ...]
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendSpec] = None
    tie_embeddings: bool = False
    rms_eps: float = 1e-6
    max_seq_len: int = 131_072
    supports_long_context: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # Implementation selector for MoE dispatch:
    #   "einsum"  = sparse one-hot einsum (the paper's *baseline*),
    #   "dense"   = dense mapping-table dispatch (paper §5.4),
    #   "grouped" = dropless expert-sorted dispatch — no expert_capacity, no
    #               token drops, tile-level padding only (MegaBlocks-style;
    #               core/dispatch_grouped.py + kernels/expert_mlp_grouped.py),
    #   "ep"      = dense dispatch + explicit expert-parallel all-to-all
    #               under shard_map (paper §5.2-5.3).
    moe_impl: str = "dense"
    # --- expert-parallel serving mesh (serving/ep.py) ---
    # () = single-device serving.  (8,) = flat EP over 8 devices.  (4, 2) =
    # two-axis ("pod", ep_axis) mesh: hierarchical two-hop all-to-all (paper
    # Fig. 8) when experts shard over both axes.  The engines build the mesh,
    # place expert weights per-device, and rewrite moe_impl to the serving EP
    # schedule ("ep_serve"/"ep_grouped"); the scheduler stays host-side and
    # mesh-agnostic.
    ep_mesh: Tuple[int, ...] = ()
    ep_axis: str = "data"

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.segments)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        out = []
        for seg in self.segments:
            out.extend(list(seg.pattern) * seg.repeats)
        return tuple(out)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Helpers used by the per-arch config modules
# ---------------------------------------------------------------------------


def uniform_segments(layer: LayerSpec, n_layers: int) -> Tuple[Segment, ...]:
    return (Segment(pattern=(layer,), repeats=n_layers),)


def patterned_segments(pattern: Tuple[LayerSpec, ...], n_layers: int) -> Tuple[Segment, ...]:
    """Tile ``pattern`` to cover ``n_layers``; remainder becomes a repeat-1 tail."""
    p = len(pattern)
    reps, rem = divmod(n_layers, p)
    segs = []
    if reps:
        segs.append(Segment(pattern=pattern, repeats=reps))
    if rem:
        segs.append(Segment(pattern=pattern[:rem], repeats=1))
    return tuple(segs)


# ---------------------------------------------------------------------------
# Closed-form parameter counting (used for PR-MoE / MoS size claims)
# ---------------------------------------------------------------------------


def _ffn_matrices(act: str) -> int:
    return 3 if act == "swiglu" else 2


def ffn_param_count(cfg: "ModelConfig", f: FFNSpec, active: bool = False) -> int:
    d = cfg.d_model
    if f.kind == "none":
        return 0
    per_expert = _ffn_matrices(f.act) * d * f.d_ff
    if f.kind == "dense":
        return per_expert + d  # + pre-norm scale
    n_experts = f.top_k if active else f.num_experts
    total = n_experts * per_expert
    total += d * f.num_experts  # router (always fully read for gating)
    if f.residual:
        rdf = f.residual_d_ff or f.d_ff
        total += _ffn_matrices(f.act) * d * rdf
    return total + d


def mixer_param_count(cfg: "ModelConfig", m) -> int:
    d = cfg.d_model
    if isinstance(m, AttnSpec):
        qo = d * cfg.num_heads * cfg.head_dim * 2
        kv = d * cfg.num_kv_heads * cfg.head_dim * 2
        return qo + kv + d  # + pre-norm
    if isinstance(m, SSMSpec):
        di, s = m.d_inner, m.state_dim
        n = d * (2 * di + 2 * m.n_groups * s + m.num_heads)  # in_proj (z,x,B,C,dt)
        n += (di + 2 * m.n_groups * s) * m.conv_dim  # temporal conv
        n += m.num_heads * 3  # A_log, D, dt_bias
        n += di * d  # out_proj
        return n + d
    if isinstance(m, LRUSpec):
        w = m.lru_width
        n = 2 * d * w  # x & gate input projections
        n += w * m.conv_dim  # temporal conv
        n += 2 * ((w // m.num_heads) * w + w)  # block-diag input/forget gates
        n += w  # Lambda param
        n += w * d  # out proj
        return n + d
    raise TypeError(f"unknown mixer {m!r}")


def _stack_params(cfg: "ModelConfig", segs: Tuple[Segment, ...], active: bool) -> int:
    t = 0
    for seg in segs:
        for ls in seg.pattern:
            per = mixer_param_count(cfg, ls.mixer) + ffn_param_count(cfg, ls.ffn, active)
            if ls.cross is not None:
                per += mixer_param_count(cfg, ls.cross)
            t += per * seg.repeats
    return t


def count_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    n = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d  # embed/unembed + final norm
    n += _stack_params(cfg, cfg.segments, active=False)
    if cfg.encoder is not None:
        n += _stack_params(cfg, cfg.encoder.segments, active=False)
    return n


def count_active_params(cfg: ModelConfig) -> int:
    """Per-token activated parameters — the MoE 'critical data path' (paper §5.1)."""
    d = cfg.d_model
    n = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    n += _stack_params(cfg, cfg.segments, active=True)
    if cfg.encoder is not None:
        n += _stack_params(cfg, cfg.encoder.segments, active=True)
    return n
