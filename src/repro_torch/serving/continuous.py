"""Continuous batching (``repro/serving/continuous.py``): a fixed pool of
decode *slots*, requests admitted into free slots, every engine tick one
batched decode step over every slot at its own position.

Two KV-storage models share the scheduler, as in JAX:

  * **contiguous** (``paged=False``, the default): each slot owns a
    ``capacity``-token cache row.  Admission prefills the whole context into
    the slot's row (``models.model.prefill_into_slot``, kernel 6), and each
    tick decodes every slot through ``ragged_decode_step`` (kernel 9 over an
    int8 cache, the plain ``_sdpa`` over an fp one, as JAX does).
  * **paged** (``paged=True``): cache memory is a shared pool of
    ``page_size``-token pages (``serving/kv_pool.py``); each slot holds a
    block table.  Admission goes by free-block count: a request is admitted
    into a free slot when the pool has pages for its whole context (all or
    nothing), and the queue head blocks rather than being skipped.  Tables
    grow lazily as sequences decode; pages return to the pool (their
    positions reset to -1) the moment a request finishes; when the pool runs
    dry the youngest slot is preempted back to the queue head and later
    resumes by re-prefilling prompt + generated tokens, so greedy decoding
    continues token-exact.  Decode goes through ``paged_ragged_decode_step``
    (kernel 7).

Paged admission prefill has three modes (``prefill_mode``):

  * ``"chunked"`` (default): a resumable state machine; each ``step()``
    spends at most ``prefill_chunk`` tokens of prefill compute (page-aligned
    chunks written straight into the slot's pages by
    ``paged_prefill_chunk``, kernel 8), then decodes every slot that is not
    mid-prefill.
  * ``"batched"``: every mid-prefill slot advances one chunk per tick in ONE
    model call (``paged_prefill_chunk_batched``: one launch of the batched
    kernel 8 per layer), padded to ``[slots, prefill_chunk]``.
  * ``"scatter"``: the parity oracle; admission prefills the whole context
    into a temporary contiguous cache and scatters it into the pages
    (``paged_prefill_into_slot``, kernel 6).

``prefix_sharing=True`` adds prefix sharing with copy-on-write: a radix
index over full-page token chunks (``serving/prefix_index.py``) maps live
prompt prefixes to physical pages, so a request whose context repeats an
admitted prefix points its table at the existing pages (refcounted through
``KVBlockPool.share``) and, where every layer of the arch is paged, skips
their prefill compute; an arch with window rings or SSM / LRU states
(gemma3, recurrentgemma, mamba2), which keeps them per slot beside the
pool, recomputes the shared prefix to rebuild them, its writes into the
shared pages sent to the trash page.  ``submit_n`` rides the same mechanism: n
samples of one prompt share ALL its pages, the partial boundary page too,
and draw their first tokens from the base's stashed prefill logits.  Before
a slot appends into a page another slot holds, ``_ensure_pages`` forks it a
private copy (``pool.fork`` + ``paged_copy_page``, a device copy of host-
known page ids), so a page visible to another slot is never written.

Device work per tick: at most one upload of the tick's tokens, positions and
tables (one int32 buffer) per model call, the prefill, the CoW copies, one
decode step, and one read-back of the sampled tokens (the stop and admission
decisions need them on the host).  A prefill call that completes prompts
reads their first tokens back too (one read-back for every row that finishes
in a batched call), and a tick that ran prefill fences the device before its
decode phase so the tick's prefill/decode times are device times (as the JAX
engine's ``block_until_ready``).

Sampling draws from a ``torch.Generator``, so sampled (temperature > 0)
tokens differ from the JAX engine's; greedy tokens are the same.

Under the capacity dispatch (each config's own ``moe_impl``, ``dense`` or
``ep`` without a mesh) every row of a decode step, inactive and mid-prefill
slots included, and every token of a chunk (a batched chunk's padding
included) competes for its expert's slots in token-major order.  The engine
feeds those rows what the JAX engine feeds them (the slot's last token at
position 0, a batched chunk padded with token 0 at position -1).  A paged
row or a padded query with no valid key gets attention 0 from the kernels,
as from the JAX package's Pallas kernels, so past one expert's capacity the
two engines drop and route alike when the JAX engine runs its kernels; its
CPU oracle path gives such a row a uniform average instead (ROADMAP.md,
queue 3).

Like ``Engine``, it takes MoQ-quantized parameters, and
``kv_cache_bits=8`` makes the cache int8 (quantized on write, read by the
int8 branches of the kernels).

``spec_draft=(drafter cfg, drafter params)`` (paged, greedy) makes every
decode tick speculative (``serving/spec.py``): the drafter proposes
``spec_k`` tokens per decoding slot, ONE batched verify pass over every
slot's ``k + 1`` window (``paged_verify_chunk_batched``: the batched kernel 8
once per layer, no kernel 7) writes the window into copy-on-write forks and
fresh pages, the longest agreeing prefix commits by refcount handoff and
the rest rolls back by dropping pages.  The tokens are the non-speculative
greedy engine's.  A speculative tick reads back twice: the proposals and
the verify argmax ``[slots, k + 1]``.  A target with per-slot state
(window rings, SSM / LRU states), which the verify pass leaves untouched,
re-runs each slot's accepted tokens after the commit through
``paged_prefill_chunk_batched`` (the batched kernel 8 once per paged layer),
which advances those leaves; its pool writes all go to the trash page (the
``already`` guard: every accepted position is stored in a committed page).
A drafter with per-slot state resyncs after a partial accept
(``serving/spec.py``); ``spec_resyncs`` counts it.

An encoder-decoder config is refused with a ``ValueError``: the engine takes
no encoder memory, as the JAX engine takes none.  A vlm config serves its
text tokens (no patch embeddings), as the JAX engine does.

``obs`` (``repro_torch.obs.Obs``; a default one, metrics on, when None)
records the JAX engine's instruments under the same names: the SLO
histograms (``serve.queue_wait_s``, ``ttft_s``, ``tpot_s``, ``tick_s``,
``preempts_per_req``), the lifecycle counters and the pool gauges, the
``spec.*`` counters and histograms of a speculative engine, and, with
``obs.routing``, the ``routing.*`` gauges of every decode tick (the stats
stay on the device and reach the host in one copy per tick, after the
tick's token read-back; ``metrics_log`` gets their summary).  The tracer
(``obs.tracer``, when enabled) writes three span tracks: ``engine 0``
(``tick`` spans; ``spec_draft`` / ``spec_verify`` / ``spec_commit`` inside a
speculative tick; ``preempt`` and ``cow_copy`` instants), ``slot i`` (a
``req{rid}`` span per residency, with ``chunk[a:b)`` spans inside) and
``request rid`` (``queued`` -> ``prefill`` -> ``decode``, ``prefix_hit``,
``preempted``, ``spec_commit`` and ``complete`` instants).  ``tick_s`` is
read after the tick's token read-back (by then the device has finished the
decode step) and the bookkeeping that follows it; a tick that prefills
fences once after its prefill phase anyway.  The instruments add no sync.  ``serve.jitted_calls_per_tick``
counts the model-step calls a tick makes (JAX's jitted calls, one per
call site of its engine).  The port compiles nothing, so the watchdog
registers no function and ``serve.retraces`` stays 0.

Under ``cfg.ep_mesh`` (expert-parallel serving, serving/ep.py) the engine
runs as one rank of an SPMD group, as ``Engine`` does: the same scheduler
and host decisions on every rank, this rank's expert slice, the page pool
replicated and the per-slot caches (the contiguous engine's rows, every
engine's rings and SSM / LRU states) cut to this rank's block of slots
where the slots divide over the ``batch`` axes (``place_caches``), the
model calls of ``submit``, ``submit_n`` and ``step`` under the mesh.  The
decode tick and the batched prefill tick run the non-expert layers on the
rank's slots (the tick's upload is the whole buffer, every rank's host
state being the same) and gather the sampled tokens; one-slot admissions
and chunks run on every rank, the slot's per-slot row sent by its holder;
a fork's per-slot row goes from its base's holder to its own.  Speculative
decoding over a mesh is refused with ``NotImplementedError``, as in the JAX
package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gating import routing_to_host, summarize_routing
from repro_torch.models.model import (
    arch_fully_paged,
    init_caches,
    init_paged_caches,
    paged_copy_page,
    paged_copy_slot_leaves,
    paged_prefill_chunk,
    paged_prefill_chunk_batched,
    paged_prefill_into_slot,
    paged_ragged_decode_step,
    paged_reset_page_tails,
    paged_reset_pages,
    paged_verify_chunk_batched,
    prefill_into_slot,
    ragged_decode_step,
    resolve_device,
)
from repro_torch.obs import Obs
from repro_torch.quant.ptq import prepare_params_for_serving
from repro_torch.serving.engine import Request, Response
from repro_torch.serving.ep import (
    gather_rows,
    gather_sampled,
    init_engine_mesh,
    mesh_scope,
    mesh_size,
    place_caches,
    place_params,
)
from repro_torch.serving.kv_pool import BlockTables, KVBlockPool
from repro_torch.serving.prefix_index import PrefixIndex
from repro_torch.serving.sampling import sample
from repro_torch.serving.spec import Drafter, accept_length


@dataclass
class SlotState:
    """One decode slot's scheduler-side state.

    ``prefilling`` implies ``active``: the slot holds all its pages but is
    left out of decode ticks and of lazy growth and CoW.  While prefilling,
    ``pos == prefill_done`` = positions already written (a prefix-sharing
    admission starts both past the shared pages), and ``generated`` holds
    only tokens carried over from a preemption; once prefill completes,
    ``generated[-1]`` is sampled but not yet written."""

    request_id: int = -1
    pos: int = 0  # next absolute position
    generated: List[int] = field(default_factory=list)
    budget: int = 0
    active: bool = False
    admit_seq: int = -1  # admission order: youngest-first preemption key
    prompt_len: int = 0  # original (untruncated) prompt length
    # the request's prompt WITHOUT generated tokens: preemption re-queues
    # (prompt, generated) separately, so a second preemption does not
    # duplicate the generated prefix
    prompt: List[int] = field(default_factory=list)
    # the last context token's logits [1, V] on the device, kept under prefix
    # sharing until the slot's first decode tick: forks draw their first
    # token from it without a prefill
    prefill_logits: Optional[torch.Tensor] = None
    prefilling: bool = False
    prefill_ctx: List[int] = field(default_factory=list)
    prefill_done: int = 0
    prefill_started: bool = False  # a chunk of this admission has run
    # tokens by cache position from prefill completion on: context, then the
    # generated tokens; len(seq) == pos + 1 and seq[pos] == generated[-1]
    # (sampled, not yet written).  The drafter is fed and re-synced from it.
    seq: List[int] = field(default_factory=list)


@dataclass
class _Pending:
    """Queue entry; ``generated`` is non-empty for a preempted request, which
    re-admission prefills over ``prompt + generated``.  ``fork_of`` >= 0: a
    parallel sample of that request id (``submit_n``), which shares all its
    base's pages if the base is still at its admission state when this
    entry reaches the queue head."""

    rid: int
    prompt: List[int]
    budget: int  # total response budget, clamped to capacity - 1
    generated: List[int]
    prompt_len: int
    fork_of: int = -1


class ContinuousEngine:
    """Slot-pool continuous batching on ``device`` (the card unless the
    caller passes ``"cpu"``).  ``step()`` is one engine tick; ``submit()``
    queues a request and admits what fits; ``submit_n()`` queues parallel
    samples of one prompt."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4, capacity: int = 256,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 eos_id: int = -1, seed: int = 0, kv_cache_bits: int = 0,
                 paged: bool = False, page_size: Optional[int] = None,
                 n_pages: Optional[int] = None, prefix_sharing: bool = False,
                 prefill_chunk: int = 0, prefill_mode: str = "chunked",
                 spec_draft: Optional[tuple] = None, spec_k: int = 4, obs=None,
                 device="cuda"):
        if prefix_sharing and not paged:
            raise ValueError("prefix_sharing requires paged=True (block tables)")
        if prefill_mode not in ("chunked", "batched", "scatter"):
            raise ValueError(
                f"prefill_mode must be 'chunked', 'batched' or 'scatter', got {prefill_mode!r}")
        if prefill_mode == "batched" and not paged:
            raise ValueError("prefill_mode='batched' requires paged=True: the batched chunk "
                             "prefill writes directly into pool pages through block tables")
        if cfg.encoder is not None:
            raise ValueError(f"ContinuousEngine: {cfg.name} is an encoder-decoder model, and the "
                             "engine takes no encoder memory; serve it through Engine(memory=...)")
        if spec_draft is not None:
            # draft-then-verify (serving/spec.py): spec_draft = (drafter cfg, params)
            if not paged:
                raise ValueError("speculative decoding requires paged=True: rollback is "
                                 "implemented as dropping CoW page forks")
            if temperature > 0.0:
                raise ValueError("speculative decoding is greedy-only: verification accepts the "
                                 "longest argmax-agreeing draft prefix, which is exact for "
                                 "temperature=0 and has no sampling analogue here")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if spec_draft[0].vocab_size != cfg.vocab_size:
                raise ValueError(f"drafter vocab_size {spec_draft[0].vocab_size} != target "
                                 f"vocab_size {cfg.vocab_size}: drafted token ids must be target "
                                 "token ids for verification to compare them")
        if spec_draft is not None and mesh_size(cfg.ep_mesh) > 1:
            raise NotImplementedError(
                "speculative decoding is not implemented over an expert-parallel serving mesh: "
                "the verify window's CoW fork plan is host-side per slot while the mesh "
                "replicates the page pool per rank - run without cfg.ep_mesh / --ep-devices, "
                "or drop --spec-draft")
        obs = obs if obs is not None else Obs()
        if spec_draft is not None and obs.routing:
            raise ValueError("routing collection is incompatible with speculative decoding: the "
                             "verify pass replaces the plain decode step and returns no "
                             "RoutingStats")
        self.device = resolve_device(device)
        # the EP serving mesh (cfg.ep_mesh) rewrites moe_impl to its schedule
        self._mesh, self._mesh_rules, cfg = init_engine_mesh(cfg)
        with mesh_scope(self._mesh, self._mesh_rules):
            params = prepare_params_for_serving(cfg, params)
        if self._mesh is not None:
            params = place_params(self._mesh, self._mesh_rules, params, cfg)
        leaf = params["embed"]
        if leaf.device != self.device:
            raise ValueError(f"ContinuousEngine: parameters are on {leaf.device}, the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = slots
        self.capacity = capacity
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.kv_cache_bits = kv_cache_bits
        self.paged = paged
        self.prefix_sharing = prefix_sharing
        self.prefill_mode = prefill_mode
        self.prefix: Optional[PrefixIndex] = None
        if paged:
            self.page_size = page_size = int(page_size or 16)
            # tokens of prefill compute per tick (0 = auto); chunk boundaries
            # are page-aligned, so at least one page per tick
            self.prefill_chunk = int(prefill_chunk) if prefill_chunk else max(64, page_size)
            if self.prefill_chunk < page_size:
                raise ValueError(f"prefill_chunk={self.prefill_chunk} must be >= page_size="
                                 f"{page_size} (chunk boundaries are page-aligned)")
            # a shared prefix's prefill compute is skipped when every mixer's
            # state is paged; window rings and SSM / LRU states are rebuilt by
            # running the prefix (its writes into shared pages go to the trash
            # page: the attention layers' ``already`` rule)
            self._skip_shared_compute = arch_fully_paged(cfg)
            self.max_pages = -(-capacity // page_size)  # table entries per slot
            # n_pages None/0 = auto: the contiguous worst case
            self.n_pages = int(n_pages) if n_pages else slots * self.max_pages
            if self.n_pages < self.max_pages:
                raise ValueError(f"n_pages={self.n_pages} cannot hold even one full-capacity "
                                 f"sequence ({self.max_pages} pages of {page_size})")
            self.pool = KVBlockPool(self.n_pages, page_size)
            self.tables = BlockTables(slots, self.max_pages)
            if prefix_sharing:
                self.prefix = PrefixIndex(page_size)
            self.caches = init_paged_caches(cfg, slots, capacity, n_pages=self.n_pages,
                                            page_size=page_size, kv_bits=kv_cache_bits,
                                            device=self.device)
        else:
            self.caches = init_caches(cfg, slots, capacity, kv_bits=kv_cache_bits,
                                      device=self.device)
        if self._mesh is not None:
            self.caches = place_caches(self._mesh, self._mesh_rules, self.caches, slots=slots,
                                       n_pages=self.n_pages if paged else None)
        self.slots = [SlotState() for _ in range(slots)]
        self.queue: List[_Pending] = []
        self.done: Dict[int, Response] = {}
        self.preemptions = 0
        self.cow_copies = 0  # pages privately copied before a divergent append
        self.prefix_hits = 0  # admissions that shared at least one page
        self.prefix_hit_tokens = 0  # context tokens served from shared pages
        self.prefill_tokens_total = 0  # prompt tokens computed at prefill
        # context tokens whose prefill compute was skipped because their K/V
        # is read from shared pages in place (chunked and batched modes)
        self.prefill_tokens_skipped = 0
        self.prefill_calls_total = 0  # model prefill calls: chunks, batched calls, admissions
        self.metrics_log: List[dict] = []  # one entry per tick, the last 65536
        # the last decode tick's [slots, V] (this rank's slots under a mesh)
        self.last_logits: Optional[torch.Tensor] = None
        # the current tick's shared prefill budget (None outside step()):
        # admissions cascaded from completions mid-tick draw from it too
        self._tick_budget: Optional[int] = None
        self._tick_prefill_done = 0
        self._tick_prefill_calls = 0
        self._batched_occ_tick = 0.0  # rows with a chunk in this tick's batched call / slots
        # model-step calls since the last recorded tick (JAX's jitted calls:
        # prefills, page resets and copies, drafter calls, verify, decode)
        self._jit_calls_tick = 0
        self._tick = 0
        self._next_id = 0
        self._admit_counter = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._cur_token = np.zeros((slots,), np.int32)
        self._init_obs(obs)
        # speculative decoding: the drafter, this tick's spec record (JAX's
        # keys), its phase times, and the resyncs (also spec.draft_resyncs)
        self.spec_k = int(spec_k) if spec_draft is not None else 0
        self.drafter: Optional[Drafter] = None
        self._spec_tick_m: dict = {}
        self._spec_times: dict = {}
        self.spec_resyncs = 0
        if spec_draft is not None:
            M = self.obs.metrics
            self._h_accept = M.histogram("spec.accept_rate", unit="", lo=1.0 / (4 * self.spec_k),
                                         hi=1.0 + 1e-9, n_buckets=16)
            self._h_tok_verify = M.histogram("spec.tokens_per_verify", unit="tok", lo=1.0,
                                             hi=float(self.spec_k + 1) + 1e-9, n_buckets=16)
            self._c_spec_drafted = M.counter("spec.draft_tokens", unit="tok")
            self._c_spec_accepted = M.counter("spec.accepted_tokens", unit="tok")
            self._c_spec_verifies = M.counter("spec.verify_windows")
            self._c_spec_commit_pages = M.counter("spec.committed_pages", unit="page")
            self._c_spec_rollback_pages = M.counter("spec.rolled_back_pages", unit="page")
            self._c_spec_resyncs = M.counter("spec.draft_resyncs")
            dcfg, dparams = spec_draft
            self.drafter = Drafter(dcfg, prepare_params_for_serving(dcfg, dparams), slots=slots,
                                   capacity=capacity, spec_k=self.spec_k, device=self.device)
            if self.drafter.params["embed"].device != self.device:
                raise ValueError(f"ContinuousEngine: drafter parameters are on "
                                 f"{self.drafter.params['embed'].device}, the engine on "
                                 f"{self.device}")

    # -- observability (the JAX engine's instruments, same names) --------
    def _init_obs(self, obs: Obs) -> None:
        self.obs = obs
        # hoisted enabled-check: a disabled tracer costs one attribute test
        self._tr = obs.tracer if obs.tracer.enabled else None
        M = obs.metrics
        self._h_queue = M.histogram("serve.queue_wait_s")
        self._h_ttft = M.histogram("serve.ttft_s")
        self._h_tpot = M.histogram("serve.tpot_s", lo=1e-5, hi=10.0)
        self._h_tick = M.histogram("serve.tick_s")
        self._h_preempts = M.histogram("serve.preempts_per_req", unit="", lo=1.0, hi=1024.0,
                                       n_buckets=10)
        self._c_submitted = M.counter("serve.requests_submitted", unit="req")
        self._c_completed = M.counter("serve.requests_completed", unit="req")
        self._c_decode_toks = M.counter("serve.decode_tokens", unit="tok")
        self._c_prefill_toks = M.counter("serve.prefill_tokens_computed", unit="tok")
        self._c_prefill_skip = M.counter("serve.prefill_tokens_skipped", unit="tok")
        self._c_preempt = M.counter("serve.preemptions")
        self._c_cow = M.counter("serve.cow_copies", unit="page")
        self._c_prefix_hits = M.counter("serve.prefix_hits")
        self._c_prefix_toks = M.counter("serve.prefix_hit_tokens", unit="tok")
        self._c_retraces = M.counter("serve.retraces", unit="compile")
        self._g_active = M.gauge("serve.active_slots")
        self._g_queue = M.gauge("serve.queue_depth")
        self._g_free_pages = M.gauge("serve.free_pages")
        self._g_occupancy = M.gauge("serve.page_occupancy")
        self._g_peak_occ = M.gauge("serve.peak_page_occupancy")
        self._g_shared = M.gauge("serve.shared_pages")
        self._g_jit_calls = M.gauge("serve.jitted_calls_per_tick", unit="call")
        self._g_batch_occ = M.gauge("serve.batched_prefill_occupancy")
        self._g_r_drop = M.gauge("routing.dropped_frac")
        self._g_r_ent = M.gauge("routing.entropy", unit="nat")
        self._g_r_imb = M.gauge("routing.imbalance")
        # per-request SLO state (t_submit / t_admit / t_first / t_last /
        # n_tokens / preempts), popped into the histograms at completion
        self._req_obs: Dict[int, dict] = {}

    def _obs_submitted(self, rid: int) -> None:
        self._c_submitted.inc()
        self._req_obs[rid] = {"t_submit": time.perf_counter(), "t_admit": None, "t_first": None,
                              "t_last": None, "n_tokens": 0, "preempts": 0}
        if self._tr:
            self._tr.begin(("request", rid), "queued")

    def _obs_admit_time(self, rid: int) -> float:
        """Now; the request's queue wait, on its first admission only."""
        now = time.perf_counter()
        ro = self._req_obs.get(rid)
        if ro is not None and ro["t_admit"] is None:
            ro["t_admit"] = now
            self._h_queue.observe(now - ro["t_submit"])
        return now

    def _obs_admitted(self, rid: int, i: int) -> None:
        now = self._obs_admit_time(rid)
        if self._tr:
            self._tr.end(("request", rid), ts=now)  # queued
            self._tr.begin(("request", rid), "prefill", ts=now)
            self._tr.begin(("slot", i), f"req{rid}", ts=now)

    def _obs_admitted_fork(self, rid: int, i: int, base_rid: int) -> None:
        now = self._obs_admit_time(rid)
        if self._tr:
            self._tr.end(("request", rid), ts=now)  # queued
            self._tr.instant(("request", rid), "prefix_hit", ts=now, args={"fork_of": base_rid})
            self._tr.begin(("request", rid), "decode", ts=now)
            self._tr.begin(("slot", i), f"req{rid}", ts=now)

    def _obs_token(self, rid: int, now: float) -> None:
        """One generated token: TTFT on the first, TPOT on the rest.  An
        interval broken by a preemption is dropped (``t_last`` reset): the
        re-queue wait is preemption cost, not inter-token latency."""
        ro = self._req_obs.get(rid)
        if ro is None:
            return
        if ro["t_first"] is None:
            ro["t_first"] = now
            self._h_ttft.observe(now - ro["t_submit"])
        elif ro["t_last"] is not None:
            self._h_tpot.observe(now - ro["t_last"])
        ro["t_last"] = now
        ro["n_tokens"] += 1

    def _obs_first_token(self, rid: int) -> None:
        """Prefill done, first token sampled: the request's prefill span
        becomes a decode span."""
        now = time.perf_counter()
        self._obs_token(rid, now)
        if self._tr:
            self._tr.end(("request", rid), ts=now)  # prefill
            self._tr.begin(("request", rid), "decode", ts=now)

    def _obs_completed(self, rid: int) -> None:
        now = time.perf_counter()
        ro = self._req_obs.pop(rid, None)
        if ro is not None:
            self._c_completed.inc()
            self._h_preempts.observe(ro["preempts"])
        if self._tr:
            self._tr.end(("request", rid), ts=now)  # decode
            self._tr.instant(("request", rid), "complete", ts=now)

    def _count_prefill(self, n: int) -> None:
        self.prefill_tokens_total += n
        self._c_prefill_toks.inc(n)

    def _count_prefix_hit(self, tokens: int) -> None:
        self.prefix_hits += 1
        self.prefix_hit_tokens += tokens
        self._c_prefix_hits.inc()
        self._c_prefix_toks.inc(tokens)

    def _count_cow(self) -> None:
        self.cow_copies += 1
        self._c_cow.inc()

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self._gen, temperature=self.temperature, top_k=self.top_k,
                      top_p=self.top_p)

    def _sample_all(self, logits: torch.Tensor, n: int) -> torch.Tensor:
        """Every row's token of a step over ``n`` rows, on every rank (this
        rank's rows of the logits under a mesh, gathered)."""
        return gather_sampled(logits, n, self._sample, self.temperature <= 0.0)

    def _clamped_budget(self, req: Request) -> int:
        # the response plus at least one context token must fit the
        # per-sequence capacity
        return max(1, min(req.max_new_tokens, self.capacity - 1))

    def submit(self, req: Request) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(_Pending(rid=rid, prompt=list(req.prompt), budget=self._clamped_budget(req),
                                   generated=[], prompt_len=len(req.prompt)))
        self._obs_submitted(rid)
        with mesh_scope(self._mesh, self._mesh_rules):
            self._admit()
        return rid

    def submit_n(self, req: Request, n: int) -> List[int]:
        """Submit ``n`` parallel samples of one prompt (one request id each).
        Under ``prefix_sharing`` the first is admitted normally and the rest
        fork it: their tables share ALL its pages (the partial boundary page
        too), so n samples cost one prompt's pages and one prefill until they
        diverge by copy-on-write.  Without sharing (or when slots or pages
        stagger the admissions) each sample is an independent request: the
        same tokens, no sharing."""
        if n < 1:
            raise ValueError(f"need n >= 1 samples, got {n}")
        budget = self._clamped_budget(req)
        rids: List[int] = []
        for j in range(n):
            rid = self._next_id
            self._next_id += 1
            self.queue.append(_Pending(rid=rid, prompt=list(req.prompt), budget=budget,
                                       generated=[], prompt_len=len(req.prompt),
                                       fork_of=rids[0] if j else -1))
            rids.append(rid)
            self._obs_submitted(rid)
        with mesh_scope(self._mesh, self._mesh_rules):
            self._admit()
        return rids

    # ------------------------------------------------------------------
    def _fork_base_slot(self, item: _Pending) -> Optional[int]:
        """Slot of ``item``'s fork base iff the base is still exactly at its
        admission state: active, no decode tick since (its cache holds the
        context and nothing else; its one generated token is sampled but not
        written), prefill logits stashed.  Otherwise the boundary page may
        hold divergent tokens, and the fork is admitted as a request."""
        if self.prefix is None or item.fork_of < 0:
            return None
        for b, s in enumerate(self.slots):
            if (s.active and not s.prefilling and s.request_id == item.fork_of
                    and len(s.generated) == 1 and s.prefill_logits is not None):
                return b
        return None

    def _fork_base_prefilling(self, item: _Pending) -> bool:
        """True while ``item``'s fork base is mid-prefill: the queue head
        blocks until the base reaches its shareable state (a bounded number
        of ticks), as FIFO admission never skips the head."""
        if self.prefix is None or item.fork_of < 0:
            return False
        return any(s.active and s.prefilling and s.request_id == item.fork_of for s in self.slots)

    def _admit_fork(self, i: int, b: int, item: _Pending) -> None:
        """Admit ``item`` into slot ``i`` as a parallel sample of slot ``b``:
        share every page ``b`` holds, point ``i``'s table at them, copy the
        per-slot leaves, and draw the first token from the base's stashed
        prefill logits.  No new page, no prefill; the first divergent append
        copies the boundary page."""
        base = self.slots[b]
        self._obs_admitted_fork(item.rid, i, base.request_id)
        pages = [int(p) for p in self.tables.row(b) if p >= 0]
        self.pool.share(pages, owner=i)
        self.tables.copy_row(i, b)
        self._jit_calls_tick += 1
        self.caches = paged_copy_slot_leaves(self.cfg, self.caches, b, i)
        # analysis: allow(host-cast) — the fork's first token, for the scheduler
        first = int(self._sample(base.prefill_logits)[0])  # the fork's first token, to the host
        self.slots[i] = SlotState(
            request_id=item.rid, pos=base.pos, generated=[first], budget=item.budget, active=True,
            admit_seq=self._admit_counter, prompt_len=item.prompt_len, prompt=item.prompt,
            prefill_logits=base.prefill_logits, seq=base.seq[:-1] + [first])
        self._admit_counter += 1
        self._cur_token[i] = first
        self._count_prefix_hit(base.pos)
        self._obs_token(item.rid, time.perf_counter())
        self._finish_if_done(i)

    def _admit(self) -> None:
        """FIFO admission into free slots.  Paged: only when the pool has
        pages for the request's whole context (the last ``capacity -
        remaining`` tokens); under prefix sharing the pages of an indexed
        full-page prefix are shared rather than allocated.  Chunked and
        batched modes reserve the pages and leave the slot ``prefilling``
        (chunked runs its first chunk here; batched joins the next tick's
        call); the scatter mode and the contiguous engine prefill the whole
        context here."""
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if not s.active]
            if not free:
                return
            i = free[0]
            item = self.queue[0]
            fork_base = self._fork_base_slot(item)
            if fork_base is not None:
                self.queue.pop(0)
                self._admit_fork(i, fork_base, item)
                continue
            if self._fork_base_prefilling(item):
                return  # the base reaches its shareable state in a few ticks
            remaining = item.budget - len(item.generated)
            # keep the LAST (capacity - remaining) context tokens, leaving
            # exactly `remaining` cache tokens to decode
            keep = self.capacity - remaining
            ctx = (item.prompt + item.generated)[-keep:]
            shared: List[int] = []
            if self.paged:
                if self.prefix is not None:
                    # leave at least one token to prefill: its logits seed
                    # the first sample
                    shared = self.prefix.lookup(ctx, max_tokens=len(ctx) - 1)
                fresh = self.pool.alloc(self.pool.pages_for(len(ctx)) - len(shared), owner=i)
                if fresh is None:
                    return  # wait for frees / completions
                if shared:
                    self.pool.share(shared, owner=i)
                    self._count_prefix_hit(len(shared) * self.page_size)
                    if self._tr:
                        self._tr.instant(("request", item.rid), "prefix_hit",
                                         args={"tokens": len(shared) * self.page_size})
                self.tables.append(i, shared + fresh)
            self.queue.pop(0)
            self._obs_admitted(item.rid, i)
            if self.paged and self.prefill_mode in ("chunked", "batched"):
                # the shared prefix is read from its pages in place, never
                # computed
                start = len(shared) * self.page_size if self._skip_shared_compute else 0
                self.prefill_tokens_skipped += start
                self._c_prefill_skip.inc(start)
                self.slots[i] = SlotState(
                    request_id=item.rid, pos=start, generated=list(item.generated),
                    budget=item.budget, active=True, admit_seq=self._admit_counter,
                    prompt_len=item.prompt_len, prompt=item.prompt, prefilling=True,
                    prefill_ctx=ctx, prefill_done=start)
                self._admit_counter += 1
                if self.prefill_mode == "chunked":
                    self._advance_prefill(i)
                continue
            # one upload: the context's tokens (paged: then the slot's table row)
            host = np.asarray(ctx, np.int32)
            if self.paged:
                host = np.concatenate([host, self.tables.row(i)])
            buf = torch.from_numpy(host).to(self.device)
            toks = buf[: len(ctx)].long()[None]
            pos = torch.arange(len(ctx), dtype=torch.int32, device=self.device)[None]
            self._jit_calls_tick += 1
            if self.paged:
                # the scatter oracle: shared positions are computed, their
                # writes go to the trash page
                logits, self.caches = paged_prefill_into_slot(
                    self.cfg, self.params, toks, pos, self.caches, buf[len(ctx):],
                    scatter_start=len(shared) * self.page_size, slot=i)
            else:
                logits, self.caches = prefill_into_slot(self.cfg, self.params, toks, pos, i,
                                                        self.caches)
            self._count_prefill(len(ctx))
            self.prefill_calls_total += 1
            # analysis: allow(host-cast) — the first token, read back for the scheduler
            first = int(self._sample(logits)[0])  # the request's first token, to the host
            self.slots[i] = SlotState(
                request_id=item.rid, pos=len(ctx), generated=item.generated + [first],
                budget=item.budget, active=True, admit_seq=self._admit_counter,
                prompt_len=item.prompt_len, prompt=item.prompt,
                prefill_logits=logits if self.prefix is not None else None,
                seq=list(ctx) + [first])
            self._admit_counter += 1
            self._cur_token[i] = first
            self._obs_first_token(item.rid)
            if self.prefix is not None:
                self._register_prefix(i, ctx, len(ctx))
            self._finish_if_done(i)

    def _register_prefix(self, i: int, ctx: List[int], end: int) -> None:
        """Index the full pages of ``ctx[:end]`` that slot ``i`` holds (pages
        already indexed keep their mapping: first writer wins).  Called once
        the pages are written, never during the call that writes them."""
        n_full = end // self.page_size
        if n_full:
            self.prefix.insert(ctx, [int(p) for p in self.tables.row(i)[:n_full]])

    def _finish_prefill(self, i: int, first: int, logits: Optional[torch.Tensor]) -> None:
        """Slot ``i`` wrote its whole context: ``first`` is its first token;
        ``logits`` [1, V], stashed under prefix sharing for forks."""
        slot = self.slots[i]
        slot.prefilling = False
        slot.seq = list(slot.prefill_ctx) + [first]
        slot.prefill_ctx = []
        slot.generated = slot.generated + [first]
        slot.prefill_logits = logits if self.prefix is not None else None
        self._cur_token[i] = first
        self._obs_first_token(slot.request_id)
        self._finish_if_done(i)

    def _advance_prefill(self, i: int) -> int:
        """Run slot ``i``'s chunked prefill up to the available budget (the
        tick's shared budget inside ``step()``, one ``prefill_chunk`` on
        admission from ``submit()``); returns the tokens computed.  Chunks
        end on page boundaries except the last, which takes the remainder;
        a leftover budget under one page waits for the next tick.  Full
        pages enter the prefix index as soon as their chunk is written; the
        last chunk's logits give the request's first token."""
        slot = self.slots[i]
        done = 0
        local_budget = self.prefill_chunk if self._tick_budget is None else None
        while slot.active and slot.prefilling:
            budget = self._tick_budget if local_budget is None else local_budget
            if budget <= 0:
                break
            ctx = slot.prefill_ctx
            start = slot.prefill_done
            end = min(len(ctx), start + budget)
            if end < len(ctx):
                aligned = end - (end % self.page_size)
                if aligned <= start:
                    break  # leftover budget < one page: resume next tick
                end = aligned
            # one upload: the chunk's tokens, then the slot's table row
            buf = torch.from_numpy(np.concatenate(
                [np.asarray(ctx[start:end], np.int32), self.tables.row(i)])).to(self.device)
            toks = buf[: end - start].long()[None]
            pos = torch.arange(start, end, dtype=torch.int32, device=self.device)[None]
            if self._tr:
                self._tr.begin(("slot", i), f"chunk[{start}:{end})", args={"rid": slot.request_id})
            self._jit_calls_tick += 1
            # the first chunk of an admission starts the slot's per-slot
            # leaves fresh; later ones resume them
            logits, self.caches = paged_prefill_chunk(self.cfg, self.params, toks, pos, self.caches,
                                                      buf[end - start:], slot=i,
                                                      reset=not slot.prefill_started)
            if self._tr:
                self._tr.end(("slot", i))
            n = end - start
            done += n
            self._count_prefill(n)
            self.prefill_calls_total += 1
            self._tick_prefill_calls += 1
            slot.prefill_started = True
            if local_budget is None:
                self._tick_budget -= n
                self._tick_prefill_done += n
            else:
                local_budget -= n
            slot.prefill_done = slot.pos = end
            if self.prefix is not None:
                self._register_prefix(i, ctx, end)
            if end == len(ctx):
                # analysis: allow(host-cast) — the first token, read back for the scheduler
                self._finish_prefill(i, int(self._sample(logits)[0]), logits)
                if self.queue:
                    self._admit()  # a fork blocked on this slot's prefill can share it now
        return done

    def _prefill_tick(self) -> None:
        """One tick's admission prefill: advance prefilling slots in
        admission order against the tick's shared budget."""
        order = sorted((i for i, s in enumerate(self.slots) if s.active and s.prefilling),
                       key=lambda i: self.slots[i].admit_seq)
        for i in order:
            if self._tick_budget <= 0:
                break
            self._advance_prefill(i)

    def _prefill_tick_batched(self) -> None:
        """One tick's admission prefill as ONE model call: every mid-prefill
        slot advances one chunk (up to ``prefill_chunk`` tokens, page-aligned
        as in ``_advance_prefill``) through ``paged_prefill_chunk_batched``
        on a fixed ``[slots, prefill_chunk]`` shape; rows without a chunk
        ride along with all -1 positions and tables.  One upload of the
        tick's tokens, positions and tables, one read-back of the first
        tokens of the rows that finish their prompt; prefix registration and
        completions follow the call, in admission order."""
        order = sorted((i for i, s in enumerate(self.slots) if s.active and s.prefilling),
                       key=lambda i: self.slots[i].admit_seq)
        plan: Dict[int, tuple] = {}
        for i in order:
            slot = self.slots[i]
            ctx, start = slot.prefill_ctx, slot.prefill_done
            end = min(len(ctx), start + self.prefill_chunk)
            if end < len(ctx):
                end -= end % self.page_size
                if end <= start:
                    continue  # < one page of room: resume next tick
            plan[i] = (start, end)
        if not plan:
            return
        S, C, MP = self.n_slots, self.prefill_chunk, self.max_pages
        tokens = np.zeros((S, C), np.int32)
        positions = np.full((S, C), -1, np.int32)
        flags = np.zeros((3, S), np.int32)  # reset, active, last_idx
        tbl = np.full((S, MP), -1, np.int32)
        for i, (start, end) in plan.items():
            n = end - start
            tokens[i, :n] = self.slots[i].prefill_ctx[start:end]
            positions[i, :n] = np.arange(start, end, dtype=np.int32)
            flags[:, i] = (not self.slots[i].prefill_started, 1, n - 1)
            tbl[i] = self.tables.row(i)
            if self._tr:
                self._tr.begin(("slot", i), f"chunk[{start}:{end})",
                               args={"rid": self.slots[i].request_id})
        buf = torch.from_numpy(np.concatenate(
            [tokens.reshape(-1), positions.reshape(-1), flags.reshape(-1), tbl.reshape(-1)])
        ).to(self.device)  # the tick's one upload
        o = 2 * S * C
        self._jit_calls_tick += 1
        logits, self.caches = paged_prefill_chunk_batched(
            self.cfg, self.params, buf[: S * C].view(S, C).long(), buf[S * C : o].view(S, C),
            buf[o : o + S].bool(), buf[o + S : o + 2 * S].bool(), buf[o + 2 * S : o + 3 * S],
            self.caches, buf[o + 3 * S :].view(S, MP))
        if self._tr:
            for i in plan:
                self._tr.end(("slot", i))
        self.prefill_calls_total += 1
        self._tick_prefill_calls += 1
        self._batched_occ_tick = len(plan) / S
        finishing = [i for i, (_, end) in plan.items() if end == len(self.slots[i].prefill_ctx)]
        firsts = None
        if finishing:
            if self.prefix is not None:
                logits = gather_rows(logits, S)  # a fork draws from its base's row
            # one read-back serves every row that finishes its prompt this tick
            # analysis: allow(host-asarray) — finishing rows' first tokens, for the scheduler
            firsts = self._sample_all(logits, S).cpu().numpy()
        for i, (start, end) in plan.items():  # admission order
            slot = self.slots[i]
            n = end - start
            self._tick_prefill_done += n
            self._count_prefill(n)
            slot.prefill_started = True
            slot.prefill_done = slot.pos = end
            ctx = slot.prefill_ctx
            if self.prefix is not None:
                self._register_prefix(i, ctx, end)
            if end == len(ctx):
                self._finish_prefill(i, int(firsts[i]),
                                     logits[i : i + 1] if self.prefix is not None else None)
        if self.queue:
            self._admit()  # a fork blocked on a base that just finished can share it now

    def _end_tick_prefill(self) -> int:
        """Close the tick's prefill budget; returns tokens spent this tick."""
        if self._tick_budget is None:
            return 0
        done = self._tick_prefill_done
        self._tick_budget = None
        self._tick_prefill_done = 0
        return done

    def _release_slot(self, i: int) -> None:
        if self._tr:
            self._tr.end(("slot", i))  # the residency span opened at admission
        if self.paged:
            # decref the slot's pages; only those no other slot holds are
            # freed (and leave the prefix index)
            freed = self.pool.release(i)
            self.tables.reset(i)
            if self.drafter is not None:
                # the next occupant (or this request's re-admission) re-syncs
                # the drafter at its first speculative tick
                self.drafter.invalidate(i)
            if freed:
                if self.prefix is not None:
                    self.prefix.evict_pages(freed)
                # invalidate the recycled pages' positions on the device, or
                # a later owner would see the previous occupant's K/V
                mask = np.zeros((self.n_pages + 1,), bool)
                mask[freed] = True
                self._jit_calls_tick += 1
                self.caches = paged_reset_pages(self.cfg, self.caches,
                                                torch.from_numpy(mask).to(self.device))
        self.slots[i] = SlotState()

    def _finish_if_done(self, i: int) -> None:
        slot = self.slots[i]
        if not slot.active or slot.prefilling:
            return
        hit_eos = self.eos_id >= 0 and slot.generated and slot.generated[-1] == self.eos_id
        if len(slot.generated) >= slot.budget or hit_eos:
            gen = slot.generated[:-1] if hit_eos else slot.generated
            self.done[slot.request_id] = Response(tokens=gen, prompt_len=slot.prompt_len)
            self._obs_completed(slot.request_id)
            self._release_slot(i)
            self._admit()

    def _preempt(self, i: int) -> None:
        """Push slot ``i`` back to the queue head and release its pages (a
        shared page is decref'd, not freed); it resumes by re-prefilling
        prompt + generated-so-far."""
        slot = self.slots[i]
        rid = slot.request_id
        self.queue.insert(0, _Pending(rid=rid, prompt=slot.prompt, budget=slot.budget,
                                      generated=slot.generated, prompt_len=slot.prompt_len))
        ro = self._req_obs.get(rid)
        if ro is not None:
            ro["preempts"] += 1
            ro["t_last"] = None  # the re-queue wait is not a TPOT interval
        if self._tr:
            now = time.perf_counter()
            self._tr.instant(("request", rid), "preempted", ts=now)
            self._tr.end(("request", rid), ts=now)  # decode (or prefill)
            self._tr.begin(("request", rid), "queued", ts=now)
            self._tr.instant(("engine", 0), "preempt", ts=now, args={"rid": rid, "slot": i})
        self._release_slot(i)
        self.preemptions += 1
        self._c_preempt.inc()

    def _youngest_active(self) -> int:
        return max((j for j, s in enumerate(self.slots) if s.active),
                   key=lambda j: self.slots[j].admit_seq)

    def _ensure_pages(self) -> None:
        """Before the decode step, per decoding slot in admission order:

        1. lazy table growth: map a page for the slot's write position; when
           the pool is dry, preempt the youngest active slot;
        2. copy-on-write: if the write position's page has another holder
           (a prefix or fork sharer), give this slot a private copy (a fresh
           page, the device copy, the table entry remapped, the original
           decref'd), so the step's write never lands in a shared page.

        Mid-prefill slots hold all their pages already, and their chunks
        write only fresh pages."""
        order = sorted((i for i, s in enumerate(self.slots) if s.active and not s.prefilling),
                       key=lambda i: self.slots[i].admit_seq)
        for i in order:
            slot = self.slots[i]
            while slot.active and self.tables.n_mapped(i) <= slot.pos // self.page_size:
                got = self.pool.alloc(1, owner=i)
                if got is not None:
                    self.tables.append(i, got)
                    continue
                victim = self._youngest_active()
                self._preempt(victim)
                if victim == i:
                    break  # this slot itself re-queued
            while self.slots[i].active:
                entry = slot.pos // self.page_size
                page = int(self.tables.row(i)[entry])
                if self.pool.refcount(page) <= 1:
                    break
                new = self.pool.fork(page, i)
                if new is None:
                    victim = self._youngest_active()
                    self._preempt(victim)
                    if victim == i:
                        break  # re-queued; a sharer keeps the page alive
                    continue  # a preemption may have dropped the refcount
                self._jit_calls_tick += 1
                self.caches = paged_copy_page(self.cfg, self.caches, page, new)
                self.tables.set_entry(i, entry, new)
                self._count_cow()
                if self._tr:
                    self._tr.instant(("engine", 0), "cow_copy", args={"slot": i, "src": page,
                                                                      "dst": new})

    # -- speculative decoding (serving/spec.py holds the drafter) ----------
    def _spec_plan_pages(self, decoding) -> Dict[int, dict]:
        """Per decoding slot, in admission order: the window size ``k`` and
        the pages the verify pass writes.  The window covers positions ``p ..
        p + k`` (the unwritten current token and k drafted ones), table
        entries ``e0 = p // ps`` through ``e1 = (p + k) // ps``:

          * the boundary entry ``e0`` (only when ``p`` is mid-page) is the
            partly filled tail page.  Shared (refcount > 1), it is forked: a
            fresh page, the device copy (``paged_copy_page`` of host page
            ids), and the verify table points at the fork, so the shared page
            is never written (commit: ``commit_fork_run``).  A private
            boundary is written in place: it always commits, since every
            window emits at least one token;
          * entries past ``e0`` are fresh pages, allocated all or nothing;
            a dry pool preempts the youngest active slot, as
            ``_ensure_pages`` does (which spec mode replaces).  On commit
            the entries through the last accepted position's page join the
            table, the rest are dropped (``drop_fork_run``).

        A preemption may take a slot planned earlier (its plan is dropped at
        the end; ``_release_slot`` freed its window pages) or the slot being
        planned (no plan)."""
        ps = self.page_size
        order = sorted((i for i in range(self.n_slots) if decoding[i]),
                       key=lambda i: self.slots[i].admit_seq)
        plans: Dict[int, dict] = {}
        for i in order:
            slot = self.slots[i]
            if not slot.active or slot.prefilling:
                continue  # preempted by an earlier plan's allocation
            p = slot.pos
            remaining = slot.budget - len(slot.generated)
            k = max(0, min(self.spec_k, remaining - 1, self.capacity - 1 - p))
            e0, e1 = p // ps, (p + k) // ps
            while True:
                slot = self.slots[i]
                if not slot.active or slot.prefilling:
                    break  # this slot itself was preempted: no plan
                boundary = int(self.tables.row(i)[e0]) if p % ps else -1
                fork_boundary = boundary >= 0 and self.pool.refcount(boundary) > 1
                need = (e1 - e0) + (0 if p % ps else 1) + (1 if fork_boundary else 0)
                got = self.pool.alloc(need, owner=i)
                if got is not None:
                    window: Dict[int, int] = {}
                    fork = -1
                    if fork_boundary:
                        fork = got.pop()
                        self._jit_calls_tick += 1
                        self.caches = paged_copy_page(self.cfg, self.caches, boundary, fork)
                        self._count_cow()
                        window[e0] = fork
                    elif boundary >= 0:
                        window[e0] = boundary  # private: written in place
                    for e, pg in zip((e for e in range(e0, e1 + 1) if e not in window), got):
                        window[e] = pg
                    plans[i] = dict(rid=slot.request_id, k=k, p=p, e0=e0, e1=e1, window=window,
                                    boundary_base=boundary if fork_boundary else -1,
                                    boundary_fork=fork)
                    break
                victim = self._youngest_active()
                self._preempt(victim)
                if victim == i:
                    break
        # drop the plans of slots a later allocation preempted: their window
        # pages were freed (and reset on the device) by _release_slot
        return {i: pl for i, pl in plans.items()
                if self.slots[i].active and not self.slots[i].prefilling
                and self.slots[i].request_id == pl["rid"]}

    def _spec_decode_tick(self, decoding) -> int:
        """One speculative decode tick: draft ``k`` tokens per decoding slot,
        verify every slot's ``k + 1`` window in ONE batched target pass over
        the planned fork tables, commit the longest argmax-agreeing prefix
        (and the target's own token at the first disagreement) by refcount
        handoff, and roll the rejected suffix back by dropping pages.
        Returns the tokens emitted.

        The order is JAX's: plan (may preempt) -> drafter sync and one
        propose -> verify -> host accept and page bookkeeping -> one page-
        tail reset (and the rolled-back pages' reset) -> completions, which
        may cascade admissions and so come after the resets (or an admitted
        slot's first chunk would be clobbered)."""
        t0 = time.perf_counter()
        plans = self._spec_plan_pages(decoding)
        if not plans:
            return 0
        ps = self.page_size
        S, C = self.n_slots, self.spec_k + 1
        t_plan = time.perf_counter()

        # draft: lazily (re)sync the drafter, then one propose for every slot
        tr = self._tr
        if tr:
            tr.begin(("engine", 0), "spec_draft")
        need_draft = []
        for i, pl in plans.items():
            slot = self.slots[i]
            if pl["k"] == 0:
                continue  # the window is the current token alone
            if self.drafter.needs_sync(i, slot.pos):
                # a fresh or re-admitted slot; one whose watermark is valid
                # but too far behind counts as a resync, as in JAX
                if self.drafter.next_pos[i] >= 0:
                    self._count_resync()
                self._jit_calls_tick += 1
                self.drafter.sync(i, slot.seq, slot.pos)
            forced = slot.seq[int(self.drafter.next_pos[i]):slot.pos + 1]
            need_draft.append((i, forced, pl["k"]))
        proposals = {}
        if need_draft:
            self._jit_calls_tick += 1
            proposals = self.drafter.propose(need_draft)
        for i, pl in plans.items():
            pl["proposal"] = proposals.get(i, [])
        t_draft = time.perf_counter()
        if tr:
            tr.end(("engine", 0), ts=t_draft)
            tr.begin(("engine", 0), "spec_verify", ts=t_draft)

        # verify: every window in one batched pass over the fork tables; one
        # upload of tokens, positions, the active mask and the tables
        tokens = np.zeros((S, C), np.int32)
        positions = np.full((S, C), -1, np.int32)
        active = np.zeros((S,), np.int32)
        tbl = np.full((S, self.max_pages), -1, np.int32)
        for i, pl in plans.items():
            k, p = pl["k"], pl["p"]
            tokens[i, 0] = self._cur_token[i]
            tokens[i, 1:1 + k] = pl["proposal"]
            positions[i, :k + 1] = np.arange(p, p + k + 1, dtype=np.int32)
            active[i] = 1
            tbl[i] = self.tables.row(i)
            for e, pg in pl["window"].items():
                tbl[i, e] = pg
        buf = torch.from_numpy(np.concatenate(
            [tokens.reshape(-1), positions.reshape(-1), active, tbl.reshape(-1)])).to(self.device)
        o = 2 * S * C
        self._jit_calls_tick += 1
        logits, self.caches = paged_verify_chunk_batched(
            self.cfg, self.params, buf[: S * C].view(S, C).long(), buf[S * C : o].view(S, C),
            buf[o : o + S].bool(), self.caches, buf[o + S :].view(S, self.max_pages))
        # greedy-only: the argmax on the device, [S, C] int32 to the host
        # analysis: allow(host-asarray) — the verify argmax, for the accept decisions
        greedy = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()  # THE read-back
        t_verify = time.perf_counter()
        if tr:
            tr.end(("engine", 0), ts=t_verify)
            tr.begin(("engine", 0), "spec_commit", ts=t_verify)

        # accept, commit and roll back (host side, admission order);
        # greedy[i, j] is the target's token for position p + j + 1
        tail_pages = np.full((S,), -1, np.int32)
        tail_offs = np.zeros((S,), np.int32)
        reset_mask = np.zeros((self.n_pages + 1,), np.int32)
        any_reset = False
        commit_rows = []
        emitted_total = accepted_total = drafted_total = 0
        for i, pl in plans.items():
            slot = self.slots[i]
            k, p = pl["k"], pl["p"]
            a = accept_length(pl["proposal"], greedy[i])
            # the accepted drafts, then the target's own token at the first
            # disagreement (the bonus token after a full accept)
            appended = [int(t) for t in pl["proposal"][:a]] + [int(greedy[i, a])]
            if self.eos_id >= 0 and self.eos_id in appended:
                appended = appended[:appended.index(self.eos_id) + 1]
            n = len(appended)  # 1 <= n <= k + 1 <= the remaining budget
            # entries through eb, the page of the last accepted position,
            # commit; later window entries roll back.  n >= 1, so eb >= e0:
            # the boundary entry always commits
            eb = (p + n - 1) // ps
            if pl["boundary_fork"] >= 0:
                freed = self.pool.commit_fork_run([pl["boundary_base"]], i)
                self.tables.set_entry(i, pl["e0"], pl["boundary_fork"])
                if freed:  # a sharer left mid-tick and left the base to this slot
                    if self.prefix is not None:
                        self.prefix.evict_pages(freed)
                    reset_mask[freed] = 1
                    any_reset = True
            grow = [pl["window"][e] for e in range(self.tables.n_mapped(i), eb + 1)]
            if grow:
                self.tables.append(i, grow)
            rollback = [pl["window"][e] for e in range(eb + 1, pl["e1"] + 1)]
            if rollback:
                freed = self.pool.drop_fork_run(rollback, i)
                reset_mask[freed] = 1
                any_reset = True
                self._c_spec_rollback_pages.inc(len(freed))
            self._c_spec_commit_pages.inc(len(grow))
            # position p + n - 1 is the last valid write of page eb; the
            # verify's writes past it (rejected drafts) are reset below
            tail_pages[i] = int(self.tables.row(i)[eb])
            tail_offs[i] = (p + n - 1) % ps + 1
            slot.pos = p + n
            slot.generated.extend(appended)
            slot.seq.extend(appended)
            slot.prefill_logits = None
            self._cur_token[i] = appended[-1]
            if self.drafter.after_commit(i, p, k, a == k, slot.pos):
                self._count_resync()  # a drafter with per-slot state, after a partial accept
            emitted_total += n
            accepted_total += a
            drafted_total += k
            self._c_spec_verifies.inc()
            self._c_spec_drafted.inc(k)
            self._c_spec_accepted.inc(a)
            if k:
                self._h_accept.observe(a / k)
            self._h_tok_verify.observe(float(n))
            if tr:
                tr.instant(("request", slot.request_id), "spec_commit", ts=t_verify,
                           args={"drafted": k, "accepted": a, "emitted": n})
            commit_rows.append((i, pl, appended))

        if not arch_fully_paged(self.cfg):
            self._jit_calls_tick += 1
            self._spec_commit(commit_rows, S, C)

        # device-side invalidation, one upload: the committed pages' tails
        # (one fixed-shape call every tick) and the rolled-back pages
        buf = torch.from_numpy(np.concatenate([tail_pages, tail_offs, reset_mask])).to(self.device)
        self._jit_calls_tick += 1
        self.caches = paged_reset_page_tails(self.cfg, self.caches, buf[:S], buf[S : 2 * S])
        if any_reset:
            self._jit_calls_tick += 1
            self.caches = paged_reset_pages(self.cfg, self.caches, buf[2 * S :].bool())
        t_commit = time.perf_counter()
        if tr:
            tr.end(("engine", 0), ts=t_commit)

        # completions last: _finish_if_done may release a slot and cascade an
        # admission into it.  The emitted tokens share one timestamp: bursty
        # TPOT is what speculative decoding delivers
        for i, pl, appended in commit_rows:
            if self.slots[i].request_id != pl["rid"]:
                continue  # released and re-admitted earlier in this loop
            for _ in appended:
                self._obs_token(pl["rid"], t_verify)
            self._finish_if_done(i)
        self._spec_tick_m.update(windows=len(commit_rows), drafted=drafted_total,
                                 accepted=accepted_total, emitted=emitted_total)
        self._spec_times = dict(plan_s=t_plan - t0, draft_s=t_draft - t_plan,
                                verify_s=t_verify - t_draft, commit_s=t_commit - t_verify)
        return emitted_total

    def _count_resync(self) -> None:
        self.spec_resyncs += 1
        self._c_spec_resyncs.inc()
        self._spec_tick_m["resyncs"] = self._spec_tick_m.get("resyncs", 0) + 1

    def _spec_commit(self, commit_rows, S: int, C: int) -> None:
        """The committed recurrent-state pass (JAX ``_spec_commit``): each
        committed slot's accepted tokens (its current token and the accepted
        drafts, positions ``p .. p + n - 1``) re-run through
        ``paged_prefill_chunk_batched``, no reset, the other rows inactive,
        so the per-slot leaves advance over exactly the committed tokens.
        Its pool writes are inert: every position it writes is already
        stored in a committed page, so the ``already`` guard sends it to the
        trash page.  One upload."""
        tokens = np.zeros((S, C), np.int32)
        positions = np.full((S, C), -1, np.int32)
        active = np.zeros((S,), np.int32)
        last = np.zeros((S,), np.int32)
        tbl = np.full((S, self.max_pages), -1, np.int32)
        for i, pl, appended in commit_rows:
            n, p = len(appended), pl["p"]
            tokens[i, :n] = self.slots[i].seq[p : p + n]
            positions[i, :n] = np.arange(p, p + n, dtype=np.int32)
            active[i] = 1
            last[i] = n - 1
            tbl[i] = self.tables.row(i)
        buf = torch.from_numpy(np.concatenate(
            [tokens.reshape(-1), positions.reshape(-1), active, last, tbl.reshape(-1)])
        ).to(self.device)
        o = 2 * S * C
        act = buf[o : o + S].bool()
        _, self.caches = paged_prefill_chunk_batched(
            self.cfg, self.params, buf[: S * C].view(S, C).long(), buf[S * C : o].view(S, C),
            torch.zeros_like(act), act, buf[o + S : o + 2 * S].long(), self.caches,
            buf[o + 2 * S :].view(S, self.max_pages))

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: at most one chunk budget of admission prefill
        (chunked; batched: one chunk per prefilling slot, one call), then one
        decode step over every active slot that is not mid-prefill.  Returns
        the number of active slots (decoding + prefilling)."""
        with mesh_scope(self._mesh, self._mesh_rules):
            return self._step()

    def _step(self) -> int:
        t0 = time.perf_counter()
        tr = self._tr
        if tr:
            tr.begin(("engine", 0), "tick", ts=t0, args={"tick": self._tick + 1})
        if self.paged and self.prefill_mode in ("chunked", "batched"):
            self._tick_budget = self.prefill_chunk
        if not any(s.active for s in self.slots):
            self._admit()
            if not any(s.active for s in self.slots):
                self._end_tick_prefill()
                if tr:
                    tr.end(("engine", 0))
                return 0
        if self._tick_budget is not None:
            if self.prefill_mode == "batched":
                self._prefill_tick_batched()
            else:
                self._prefill_tick()
        if self.paged and self.drafter is None:
            # spec mode plans lazy growth and CoW for the whole window
            # (_spec_plan_pages) instead
            self._ensure_pages()
        # mid-prefill slots do not decode; their table rows are masked to -1
        # so the decode step's writes land in the trash page
        decoding = np.asarray([s.active and not s.prefilling for s in self.slots])
        n_active = int(sum(s.active for s in self.slots))
        if self._tick_prefill_done and self.device.type == "cuda":
            # analysis: allow(block-sync) — deliberate: the prefill phase's device time ends
            torch.cuda.synchronize(self.device)  # the prefill phase's device time ends here
        t_mid = time.perf_counter()
        if not decoding.any():
            prefill_toks = self._end_tick_prefill()
            if n_active or prefill_toks:
                self._record_metrics(0, t_mid - t0, prefill_toks, n_active, t_mid - t0, 0.0)
            if tr:
                tr.end(("engine", 0))
            return n_active
        if self.drafter is not None:
            # the speculative tick takes the place of the one-token decode step
            n_decoded = self._spec_decode_tick(decoding)
            prefill_toks = self._end_tick_prefill()
            t1 = time.perf_counter()
            self._record_metrics(n_decoded, t1 - t0, prefill_toks, n_active, t_mid - t0,
                                 t1 - t_mid)
            if tr:
                tr.end(("engine", 0))
            return n_active
        S = self.n_slots
        routing = self.obs.routing
        positions = np.asarray([s.pos if s.active else 0 for s in self.slots], np.int32)
        self._jit_calls_tick += 1
        if self.paged:
            tbl = np.where(decoding[:, None], self.tables.table, -1)
            # one upload per tick: tokens, positions, the decoding rows (the
            # per-slot leaves' merge) and the block table
            buf = torch.from_numpy(np.concatenate(
                [self._cur_token, positions, decoding, tbl.reshape(-1)]).astype(np.int32)
            ).to(self.device)
            out = paged_ragged_decode_step(
                self.cfg, self.params, buf[:S].long()[:, None], buf[S : 2 * S], self.caches,
                buf[3 * S :].view(S, self.max_pages), active=buf[2 * S : 3 * S].bool(),
                return_routing=routing)
        else:
            # one upload per tick: tokens, positions and the active mask
            buf = torch.from_numpy(np.concatenate(
                [self._cur_token, positions, decoding]).astype(np.int32)).to(self.device)
            out = ragged_decode_step(self.cfg, self.params, buf[:S].long()[:, None],
                                     buf[S : 2 * S], buf[2 * S :].bool(), self.caches,
                                     return_routing=routing)
        logits, self.caches = out[:2]
        self.last_logits = logits
        # analysis: allow(host-asarray) — the tick's sampled tokens, for the scheduler
        nxt = self._sample_all(logits, S).cpu().numpy()  # THE per-tick read-back
        t_tok = time.perf_counter()
        # the routing stats' one copy, while the device is idle (the step is
        # done), before the completions below queue more work
        routing_m = summarize_routing(routing_to_host(out[2])) if routing and out[2] else None
        n_decoded = int(decoding.sum())
        for i, slot in enumerate(self.slots):
            # gate on the pre-decode snapshot: a completion at row < i can
            # admit into free row i mid-loop, and that fresh slot must not
            # take nxt[i] (computed while the row was inactive)
            if not decoding[i]:
                continue
            slot.pos += 1
            slot.generated.append(int(nxt[i]))
            slot.seq.append(int(nxt[i]))
            # the stashed prefill logits serve forks only before the first
            # decode tick
            slot.prefill_logits = None
            self._cur_token[i] = int(nxt[i])
            self._obs_token(slot.request_id, t_tok)
            self._finish_if_done(i)
        prefill_toks = self._end_tick_prefill()
        t1 = time.perf_counter()
        self._record_metrics(n_decoded, t1 - t0, prefill_toks, n_active, t_mid - t0, t1 - t_mid,
                             routing=routing_m)
        if tr:
            tr.end(("engine", 0), ts=t1, args={"decoded": n_decoded})
        return n_active

    def _record_metrics(self, n_decoded: int, dt: float, prefill_toks: int, n_active: int,
                        prefill_s: float, decode_s: float, routing: Optional[dict] = None) -> None:
        """One tick's ``metrics_log`` entry and its instruments: the tick
        histogram, the decode-token counter, the gauges, and the routing
        summary (``routing``) of a decode tick with ``obs.routing``."""
        retraces = self.obs.watchdog.tick()
        if retraces:
            self._c_retraces.inc(retraces)
        self._tick += 1
        self._h_tick.observe(dt)
        if n_decoded:
            self._c_decode_toks.inc(n_decoded)
        self._g_active.set(n_active)
        self._g_queue.set(len(self.queue))
        self._g_jit_calls.set(self._jit_calls_tick)
        m = {
            "tick": self._tick,
            "active_slots": n_active,  # slots holding pages, mid-prefill ones included
            "tokens_this_tick": n_decoded,
            "prefill_tokens": prefill_toks,
            "prefill_calls": self._tick_prefill_calls,  # model prefill calls this tick
            "tick_s": dt,
            "prefill_s": prefill_s,  # up to the fence after the tick's prefill
            "decode_s": decode_s,  # the decode step (or spec tick) and its read-backs
            "preemptions": self.preemptions,
            "retraces": retraces,
            # model-step calls this tick (JAX's "jitted_calls"), submit-time
            # admissions since the last record included
            "jitted_calls": self._jit_calls_tick,
        }
        self._jit_calls_tick = 0
        if routing is not None:
            self._g_r_drop.set(routing["dropped_frac"])
            self._g_r_ent.set(routing["entropy"])
            self._g_r_imb.set(routing["imbalance"])
            m["routing"] = {k: routing[k] for k in
                            ("moe_layers", "dropped_frac", "entropy", "imbalance")}
        if self._spec_tick_m:
            # windows, drafted, accepted, emitted: JAX's keys
            m["spec"] = self._spec_tick_m
            self._spec_tick_m = {}
        if self._spec_times:
            m.update(self._spec_times)  # plan_s, draft_s, verify_s, commit_s
            self._spec_times = {}
        self._tick_prefill_calls = 0
        if self.paged:
            occ = self.pool.occupancy
            self._g_free_pages.set(self.pool.free_count)
            self._g_occupancy.set(round(occ, 4))
            self._g_peak_occ.set(round(max(occ, self._g_peak_occ.value or 0.0), 4))
            self._g_shared.set(self.pool.shared_count)
            m.update(free_pages=self.pool.free_count, shared_pages=self.pool.shared_count,
                     cow_copies=self.cow_copies)
            if self.prefix is not None:
                m.update(prefix_hits=self.prefix_hits, prefix_hit_tokens=self.prefix_hit_tokens)
            if self.prefill_mode == "batched":
                m["batched_prefill_occupancy"] = self._batched_occ_tick
                self._g_batch_occ.set(round(self._batched_occ_tick, 4))
                self._batched_occ_tick = 0.0
        self.metrics_log.append(m)
        if len(self.metrics_log) > 65_536:
            del self.metrics_log[:-65_536]

    def run_until_done(self, max_ticks: int = 10_000) -> Dict[int, Response]:
        for _ in range(max_ticks):
            if self.step() == 0 and not self.queue:
                break
        return dict(self.done)
