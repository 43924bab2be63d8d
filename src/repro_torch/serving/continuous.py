"""Continuous batching over a paged KV pool (``repro/serving/continuous.py``,
``paged=True``, ``prefill_mode="chunked"``).

The engine keeps a fixed pool of decode *slots*.  Cache memory is a shared
pool of ``page_size``-token pages (``serving/kv_pool.py``); each slot holds a
block table.  Admission goes by free-block count: a request is admitted into
a free slot when the pool has pages for its whole context (all or nothing),
and the queue head blocks rather than being skipped.  Admission then runs as
a resumable state machine: each ``step()`` spends at most ``prefill_chunk``
tokens of prefill compute (page-aligned chunks written straight into the
slot's pages by ``models.model.paged_prefill_chunk``, through kernel 8),
then decodes every slot that is not mid-prefill in one batched step
(``paged_ragged_decode_step``, kernel 7).  Tables grow lazily as sequences
decode; pages return to the pool (their positions reset to -1) the moment a
request finishes; when the pool runs dry the youngest slot is preempted back
to the queue head and later resumes by re-prefilling prompt + generated
tokens, so greedy decoding continues token-exact.

Device work per tick: at most one upload of the tick's tokens, positions and
block table (one int32 buffer), the prefill chunks, one decode step, and one
read-back of the sampled tokens (the stop and admission decisions need them
on the host).  A prefill chunk that completes a prompt reads its first token
back too, and a tick that ran prefill fences the device before its decode
phase so the tick's prefill/decode times are device times (as the JAX
engine's ``block_until_ready``).

Sampling draws from a ``torch.Generator``, so sampled (temperature > 0)
tokens differ from the JAX engine's; greedy tokens are the same.

Under the capacity dispatch (each config's own ``moe_impl``, ``dense`` or
``ep`` without a mesh) every row of a decode step, inactive and mid-prefill
slots included, and every token of a chunk competes for its expert's slots
in token-major order.  The engine feeds those rows what the JAX engine feeds
them (the slot's last token at position 0, the chunk's tokens unpadded).  An
inactive row's attention sees no valid key, and the paged kernels give it 0,
as the JAX package's Pallas kernels do, so past one expert's capacity (more
than 8 slots) the two engines drop and route alike when the JAX engine runs
its kernels.  Its CPU oracle path gives such a row a uniform average
instead (ROADMAP.md, queue 3).

Like ``Engine``, it takes MoQ-quantized parameters, and
``kv_cache_bits=8`` makes the pool's pages int8 (quantized on write, read by
the int8 branches of the paged kernels).

Not ported here, each raising ``NotImplementedError`` that names its ROADMAP
item: the contiguous mode (``paged=False``), prefix sharing with
copy-on-write, ``submit_n``, the batched and scatter prefill modes,
speculative decoding, expert-parallel meshes and observability.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (
    init_paged_caches,
    paged_prefill_chunk,
    paged_ragged_decode_step,
    paged_reset_pages,
    resolve_device,
)
from repro_torch.quant.ptq import prepare_params_for_serving
from repro_torch.serving.engine import Request, Response
from repro_torch.serving.kv_pool import BlockTables, KVBlockPool
from repro_torch.serving.sampling import sample


def _unported(what: str, item: str):
    raise NotImplementedError(f"ContinuousEngine: {what} is not ported yet (ROADMAP.md, queue 1 {item})")


@dataclass
class SlotState:
    """One decode slot's scheduler-side state.

    ``prefilling`` implies ``active``: the slot holds all its pages but is
    left out of decode ticks and of lazy growth.  While prefilling, ``pos ==
    prefill_done`` = positions already written, and ``generated`` holds only
    tokens carried over from a preemption; once prefill completes,
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
    prefilling: bool = False
    prefill_ctx: List[int] = field(default_factory=list)
    prefill_done: int = 0


@dataclass
class _Pending:
    """Queue entry; ``generated`` is non-empty for a preempted request, which
    re-admission prefills over ``prompt + generated``."""

    rid: int
    prompt: List[int]
    budget: int  # total response budget, clamped to capacity - 1
    generated: List[int]
    prompt_len: int


class ContinuousEngine:
    """Slot-pool continuous batching over a paged KV pool, on ``device`` (the
    card unless the caller passes ``"cpu"``).  ``step()`` is one engine
    tick; ``submit()`` queues a request and admits what fits."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4, capacity: int = 256,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 eos_id: int = -1, seed: int = 0, kv_cache_bits: int = 0,
                 paged: bool = False, page_size: Optional[int] = None,
                 n_pages: Optional[int] = None, prefix_sharing: bool = False,
                 prefill_chunk: int = 0, prefill_mode: str = "chunked",
                 spec_draft: Optional[tuple] = None, obs=None, device="cuda"):
        if prefill_mode not in ("chunked", "batched", "scatter"):
            raise ValueError(
                f"prefill_mode must be 'chunked', 'batched' or 'scatter', got {prefill_mode!r}")
        if not paged:
            _unported("the contiguous mode (paged=False)", "item 3, contiguous continuous mode")
        if prefill_mode != "chunked":
            _unported(f"prefill_mode={prefill_mode!r}", "item 3, batched prefill / scatter oracle")
        if prefix_sharing:
            _unported("prefix sharing with copy-on-write", "item 3, prefix sharing")
        if spec_draft is not None:
            _unported("speculative decoding", "item 6")
        if cfg.ep_mesh:
            _unported("an expert-parallel mesh", "item 7")
        if obs is not None:
            _unported("observability (Obs)", "item 9")
        self.device = resolve_device(device)
        params = prepare_params_for_serving(cfg, params)
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
        self.page_size = page_size = int(page_size or 16)
        # tokens of prefill compute per tick (0 = auto); chunk boundaries are
        # page-aligned, so at least one page per tick
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else max(64, page_size)
        if self.prefill_chunk < page_size:
            raise ValueError(f"prefill_chunk={self.prefill_chunk} must be >= page_size="
                             f"{page_size} (chunk boundaries are page-aligned)")
        self.max_pages = -(-capacity // page_size)  # table entries per slot
        # n_pages None/0 = auto: the contiguous worst case
        self.n_pages = int(n_pages) if n_pages else slots * self.max_pages
        if self.n_pages < self.max_pages:
            raise ValueError(f"n_pages={self.n_pages} cannot hold even one full-capacity "
                             f"sequence ({self.max_pages} pages of {page_size})")
        self.pool = KVBlockPool(self.n_pages, page_size)
        self.tables = BlockTables(slots, self.max_pages)
        self.kv_cache_bits = kv_cache_bits
        self.caches = init_paged_caches(cfg, slots, capacity, n_pages=self.n_pages,
                                        page_size=page_size, kv_bits=kv_cache_bits,
                                        device=self.device)
        self.slots = [SlotState() for _ in range(slots)]
        self.queue: List[_Pending] = []
        self.done: Dict[int, Response] = {}
        self.preemptions = 0
        self.prefill_tokens_total = 0  # prompt tokens computed at prefill
        self.prefill_chunks_total = 0  # paged_prefill_chunk calls
        self.metrics_log: List[dict] = []  # one entry per tick, the last 65536
        self.last_logits: Optional[torch.Tensor] = None  # the last decode tick's [slots, V]
        # the current tick's shared prefill budget (None outside step()):
        # admissions cascaded from completions mid-tick draw from it too
        self._tick_budget: Optional[int] = None
        self._tick_prefill_done = 0
        self._next_id = 0
        self._admit_counter = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._cur_token = np.zeros((slots,), np.int32)

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self._gen, temperature=self.temperature, top_k=self.top_k,
                      top_p=self.top_p)

    def _clamped_budget(self, req: Request) -> int:
        # the response plus at least one context token must fit the
        # per-sequence capacity
        return max(1, min(req.max_new_tokens, self.capacity - 1))

    def submit(self, req: Request) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(_Pending(rid=rid, prompt=list(req.prompt), budget=self._clamped_budget(req),
                                   generated=[], prompt_len=len(req.prompt)))
        self._admit()
        return rid

    def submit_n(self, req: Request, n: int) -> List[int]:
        _unported("submit_n (parallel samples over shared pages)", "item 3, submit_n")

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """FIFO admission by free-block count: reserve a free slot and every
        page of the request's context (the last ``capacity - remaining``
        tokens), then run its first prefill chunk; later chunks run one
        budget per ``step()``."""
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if not s.active]
            if not free:
                return
            i = free[0]
            item = self.queue[0]
            remaining = item.budget - len(item.generated)
            # keep the LAST (capacity - remaining) context tokens, leaving
            # exactly `remaining` cache tokens to decode
            keep = self.capacity - remaining
            ctx = (item.prompt + item.generated)[-keep:]
            fresh = self.pool.alloc(self.pool.pages_for(len(ctx)), owner=i)
            if fresh is None:
                return  # wait for frees / completions
            self.tables.append(i, fresh)
            self.queue.pop(0)
            self.slots[i] = SlotState(
                request_id=item.rid, pos=0, generated=list(item.generated), budget=item.budget,
                active=True, admit_seq=self._admit_counter, prompt_len=item.prompt_len,
                prompt=item.prompt, prefilling=True, prefill_ctx=ctx, prefill_done=0,
            )
            self._admit_counter += 1
            self._advance_prefill(i)

    def _advance_prefill(self, i: int) -> int:
        """Run slot ``i``'s chunked prefill up to the available budget (the
        tick's shared budget inside ``step()``, one ``prefill_chunk`` on
        admission from ``submit()``); returns the tokens computed.  Chunks
        end on page boundaries except the last, which takes the remainder;
        a leftover budget under one page waits for the next tick.  The last
        chunk's logits give the request's first token."""
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
            logits, self.caches = paged_prefill_chunk(self.cfg, self.params, toks, pos, self.caches,
                                                      buf[end - start:])
            n = end - start
            done += n
            self.prefill_tokens_total += n
            self.prefill_chunks_total += 1
            if local_budget is None:
                self._tick_budget -= n
                self._tick_prefill_done += n
            else:
                local_budget -= n
            slot.prefill_done = slot.pos = end
            if end == len(ctx):
                first = int(self._sample(logits)[0])  # the request's first token, to the host
                slot.prefilling = False
                slot.prefill_ctx = []
                slot.generated = slot.generated + [first]
                self._cur_token[i] = first
                self._finish_if_done(i)
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

    def _end_tick_prefill(self) -> int:
        """Close the tick's prefill budget; returns tokens spent this tick."""
        if self._tick_budget is None:
            return 0
        done = self._tick_prefill_done
        self._tick_budget = None
        self._tick_prefill_done = 0
        return done

    def _release_slot(self, i: int) -> None:
        freed = self.pool.release(i)
        self.tables.reset(i)
        if freed:
            # invalidate the recycled pages' positions on the device, or a
            # later owner would see the previous occupant's K/V
            mask = np.zeros((self.n_pages + 1,), bool)
            mask[freed] = True
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
            self._release_slot(i)
            self._admit()

    def _preempt(self, i: int) -> None:
        """Push slot ``i`` back to the queue head and free its pages; it
        resumes by re-prefilling prompt + generated-so-far."""
        slot = self.slots[i]
        self.queue.insert(0, _Pending(rid=slot.request_id, prompt=slot.prompt, budget=slot.budget,
                                      generated=slot.generated, prompt_len=slot.prompt_len))
        self._release_slot(i)
        self.preemptions += 1

    def _youngest_active(self) -> int:
        return max((j for j, s in enumerate(self.slots) if s.active),
                   key=lambda j: self.slots[j].admit_seq)

    def _ensure_pages(self) -> None:
        """Lazy table growth before the decode step, per decoding slot in
        admission order: map a page for the slot's write position; when the
        pool is dry, preempt the youngest active slot.  (The JAX engine also
        copies a shared write page here; without prefix sharing every page
        has one holder.)  Mid-prefill slots hold all their pages already."""
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

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: at most one chunk budget of admission prefill,
        then one decode step over every active slot that is not mid-prefill.
        Returns the number of active slots (decoding + prefilling)."""
        t0 = time.perf_counter()
        self._tick_budget = self.prefill_chunk
        if not any(s.active for s in self.slots):
            self._admit()
            if not any(s.active for s in self.slots):
                self._end_tick_prefill()
                return 0
        self._prefill_tick()
        self._ensure_pages()
        # mid-prefill slots do not decode; their table rows are masked to -1
        # so the decode step's writes land in the trash page
        decoding = np.asarray([s.active and not s.prefilling for s in self.slots])
        n_active = int(sum(s.active for s in self.slots))
        if self._tick_prefill_done and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the prefill phase's device time ends here
        t_mid = time.perf_counter()
        if not decoding.any():
            prefill_toks = self._end_tick_prefill()
            if n_active or prefill_toks:
                self._record_metrics(0, t_mid - t0, prefill_toks, n_active, t_mid - t0, 0.0)
            return n_active
        S = self.n_slots
        positions = np.asarray([s.pos if s.active else 0 for s in self.slots], np.int32)
        tbl = np.where(decoding[:, None], self.tables.table, -1)
        # one upload per tick: tokens, positions and the block table
        buf = torch.from_numpy(np.concatenate(
            [self._cur_token, positions, tbl.reshape(-1)]).astype(np.int32)).to(self.device)
        logits, self.caches = paged_ragged_decode_step(
            self.cfg, self.params, buf[:S].long()[:, None], buf[S : 2 * S], self.caches,
            buf[2 * S :].view(S, self.max_pages))
        self.last_logits = logits
        nxt = self._sample(logits).cpu().numpy()  # THE per-tick read-back
        n_decoded = int(decoding.sum())
        for i, slot in enumerate(self.slots):
            # gate on the pre-decode snapshot: a completion at row < i can
            # admit into free row i mid-loop, and that fresh slot must not
            # take nxt[i] (computed while the row was inactive)
            if not decoding[i]:
                continue
            slot.pos += 1
            slot.generated.append(int(nxt[i]))
            self._cur_token[i] = int(nxt[i])
            self._finish_if_done(i)
        prefill_toks = self._end_tick_prefill()
        t1 = time.perf_counter()
        self._record_metrics(n_decoded, t1 - t0, prefill_toks, n_active, t_mid - t0, t1 - t_mid)
        return n_active

    def _record_metrics(self, n_decoded: int, dt: float, prefill_toks: int, n_active: int,
                        prefill_s: float, decode_s: float) -> None:
        self.metrics_log.append({
            "active_slots": n_active,  # slots holding pages, mid-prefill ones included
            "tokens_this_tick": n_decoded,
            "prefill_tokens": prefill_toks,
            "tick_s": dt,
            "prefill_s": prefill_s,  # up to the fence after the tick's prefill
            "decode_s": decode_s,  # the decode step and its token read-back
            "preemptions": self.preemptions,
            "free_pages": self.pool.free_count,
        })
        if len(self.metrics_log) > 65_536:
            del self.metrics_log[:-65_536]

    def run_until_done(self, max_ticks: int = 10_000) -> Dict[int, Response]:
        for _ in range(max_ticks):
            if self.step() == 0 and not self.queue:
                break
        return dict(self.done)
