"""Draft-then-verify speculative decoding over copy-on-write page forks
(``repro/serving/spec.py``).

A cheap drafter proposes ``k`` greedy tokens per decoding slot; the target
verifies all ``k + 1`` window positions of every slot in ONE batched pass
(``models.model.paged_verify_chunk_batched``, kernel 8's batched entry once
per layer), writing the window's K/V into copy-on-write forks and fresh
pages; the longest agreeing prefix commits by refcount handoff
(``KVBlockPool.commit_fork_run``) and the rejected suffix rolls back by
dropping pages (``drop_fork_run``).  Greedy verification is exact: position
``j`` of the verify logits is the target's argmax for the token at ``pos + j
+ 1``, so accepting the longest agreeing prefix plus the target's own token
at the first disagreement reproduces the non-speculative greedy stream; the
drafter moves the accept rate, never the output.

The engine side is ``ContinuousEngine._spec_decode_tick``
(``serving/continuous.py``).  This module holds the drafter: its own
contiguous caches (``init_caches``, full precision), a per-slot validity
watermark, and the propose loop.

``next_pos[i]`` is the number of sequence tokens the drafter's caches hold
correctly for slot ``i`` (-1 = invalid).  Each propose step feeds the token
at one position and writes that position's K/V, so after proposing ``k``
tokens from position ``p`` the drafter has consumed ``p .. p + k - 1``; on
commit the watermark becomes ``min(p + k, p')`` (``p'`` the slot's new
position).  After a full accept the next propose force-feeds 2 tokens (the
bonus token too).  After a partial accept the tokens past the accept point
were wrong, which is still exact for drafters whose every layer attends
over a full-context cache (``exact_partial``): contiguous attention masks by
position, and the next window's steps overwrite the stale entries index by
index before attending to them.  A drafter with per-slot state (window
rings, whose stale writes evict keys still in the window; SSM / LRU states,
which cannot step back) is invalidated instead (``after_commit`` returns
True) and re-prefills through ``sync`` at the slot's next speculative tick;
the engine counts those resyncs.  A slot release only invalidates the
watermark, and the drafter re-prefills lazily at the slot's next
speculative tick.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (
    arch_fully_paged,
    init_caches,
    prefill_into_slot,
    ragged_decode_step,
)


def accept_length(proposal: Sequence[int], greedy: Sequence[int]) -> int:
    """Longest prefix of ``proposal`` that the target's greedy tokens accept:
    ``greedy[j]`` is the target's argmax for the position after the window's
    j-th input, the token the draft proposed as ``proposal[j]``."""
    a = 0
    while a < len(proposal) and int(proposal[a]) == int(greedy[a]):
        a += 1
    return a


class Drafter:
    """The draft model: contiguous caches over the engine's slots on
    ``device``, a per-slot validity watermark, ``sync`` (one admission-style
    prefill) and ``propose`` (k + 1 ragged decode steps for every slot, one
    read-back)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, capacity: int, spec_k: int,
                 device):
        self.cfg = cfg
        self.params = params
        self.n_slots = int(slots)
        self.capacity = int(capacity)
        self.k = int(spec_k)
        self.device = device
        self.caches = init_caches(cfg, slots, capacity, kv_bits=0, device=device)
        # sequence tokens correctly consumed per slot (-1 = cache invalid)
        self.next_pos = np.full((slots,), -1, np.int64)
        # full-context attention only: exact across partial accepts (stale
        # entries are overwritten before they are read); per-slot state
        # (rings, SSM / LRU states) resyncs instead
        self.exact_partial = arch_fully_paged(cfg)
        self.syncs = self.proposes = 0  # model calls: prefills, propose loops

    def invalidate(self, slot: int) -> None:
        self.next_pos[slot] = -1

    def needs_sync(self, slot: int, pos: int) -> bool:
        """True when the slot's next propose cannot be reached by force-
        feeding at most 2 tokens (a fresh slot, a re-admission)."""
        return not (0 <= self.next_pos[slot] and pos + 1 - self.next_pos[slot] <= 2)

    def sync(self, slot: int, seq: Sequence[int], pos: int) -> None:
        """(Re)build the drafter's cache row of ``slot``: one prefill of the
        committed tokens below ``pos`` (kernel 6 on the card; the unwritten
        current token at ``pos`` is force-fed by the next propose)."""
        buf = torch.from_numpy(np.asarray(seq[:pos], np.int32)).to(self.device)
        toks = buf.long()[None]
        ppos = torch.arange(pos, dtype=torch.int32, device=self.device)[None]
        _, self.caches = prefill_into_slot(self.cfg, self.params, toks, ppos, slot, self.caches)
        self.next_pos[slot] = pos
        self.syncs += 1

    @torch.no_grad()
    def propose(self, rows: Sequence[Tuple[int, List[int], int]]) -> Dict[int, List[int]]:
        """Proposals for every row in k + 1 ragged decode steps over all
        slots: ``rows`` holds ``(slot, forced_tokens, k)``, ``forced_tokens``
        the committed tokens from the watermark through the slot's current
        token (1 or 2 of them) and ``k >= 1`` the window.  Step ``t`` feeds
        each slot its forced token where it has one and otherwise its
        previous step's argmax; the choice and the argmax stay on the device
        (inactive slots decode at position 0, their caches restored, as in
        JAX).  One upload, one read-back.  Returns slot -> k tokens."""
        T, S = self.k + 1, self.n_slots
        forced = np.zeros((T, S), np.int32)
        use_f = np.zeros((T, S), np.int32)
        pos = np.zeros((T, S), np.int32)
        act = np.zeros((T, S), np.int32)
        for slot, ftoks, k in rows:
            c = len(ftoks)
            assert 1 <= c <= 2 and c - 1 + k <= T, (c, k, T)
            base = int(self.next_pos[slot])
            for t in range(c - 1 + k):
                act[t, slot] = 1
                pos[t, slot] = min(base + t, self.capacity - 1)
                if t < c:
                    use_f[t, slot] = 1
                    forced[t, slot] = ftoks[t]
        self.proposes += 1
        buf = torch.from_numpy(np.stack([forced, use_f, pos, act])).to(self.device)  # [4, T, S]
        forced_d, use_d, pos_d, act_d = buf[0].long(), buf[1].bool(), buf[2], buf[3].bool()
        cur = forced_d[0]
        outs = []
        for t in range(T):
            inp = torch.where(use_d[t], forced_d[t], cur)
            logits, self.caches = ragged_decode_step(self.cfg, self.params, inp[:, None],
                                                     pos_d[t], act_d[t], self.caches)
            cur = torch.argmax(logits, dim=-1)
            outs.append(cur)
        outs = torch.stack(outs).to(torch.int32).cpu().numpy()  # THE read-back: [T, S]
        return {slot: [int(x) for x in outs[len(ftoks) - 1:len(ftoks) - 1 + k, slot]]
                for slot, ftoks, k in rows}

    def after_commit(self, slot: int, p: int, k: int, accepted_all: bool, new_pos: int) -> bool:
        """Advance the validity watermark after a commit: the drafter
        consumed positions ``p .. p + k - 1``, correct up to ``new_pos``.  A
        drafter with per-slot state after a partial accept is invalidated
        instead; returns True then (the engine counts a resync)."""
        if self.exact_partial or accepted_all:
            self.next_pos[slot] = min(p + k, new_pos)
            return False
        self.invalidate(slot)
        return True
