"""Paged KV-cache block pool: host-side page accounting for the serving stack.

A verbatim copy of the JAX package's ``repro/serving/kv_pool.py`` (numpy
only), so the port imports nothing of ``repro``; the JAX package's pool tests
run against both copies (``tests/test_torch_paged.py``).

The contiguous slot model reserves ``capacity`` cache tokens per slot up
front, so a 12-token request strands the other ``capacity - 12`` tokens of
cache memory for its whole lifetime — the fragmentation problem that caps
how many concurrent sequences a byte of HBM can serve (DeepSpeed-MoE §5
treats aggregate memory bandwidth/capacity as *the* serving resource).  Here
cache memory is instead a pool of fixed-size pages; each sequence owns only
the pages its tokens actually occupy, via a static-shape per-slot block
table.  Effective concurrent sequences per byte scale with 1/avg-seq-pages
rather than 1/capacity, and the win multiplies with the int8 KV cache
(quant/kv.py) since both shrink the same buffer.

Pages are **refcounted** so block tables of different slots can point at the
same physical page (prefix sharing / parallel sampling — the PagedAttention
copy-on-write model): ``share`` adds a holder, ``fork`` gives one holder a
private copy slot (the device-side copy is the engine's job), and
``release`` *decrefs* a departing slot's pages, freeing only those whose
refcount hits zero.  A shared page costs one page of memory no matter how
many tables reference it, which is what makes heavy shared-system-prompt
traffic cheap.

This module is pure host-side bookkeeping (numpy + freelist); the device
arrays it indexes into live in the model caches (models/attention.py
``init_paged_kv_cache``).  Invariants the scheduler relies on:

  * **all-or-nothing alloc** — ``alloc`` either returns exactly ``n`` pages
    or None, so admission by free-block count never half-admits a request;
  * **preemption-safe release** — every page records the set of slots
    holding it, so ``release(owner)`` drops everything a preempted/finished
    slot holds even if the scheduler's own table row has already been reset.
    A page another slot still references is decrefed, NOT freed (the old
    exclusive owner-tag model would have yanked it out from under the
    sharer), and freeing an already-free page raises instead of corrupting
    the freelist;
  * **refcounts never negative, free xor referenced** — every page is either
    on the freelist with refcount 0 and no holders, or off it with
    refcount == len(holders) >= 1 (``check()`` asserts this; the property
    fuzz in tests/test_kv_pool_prop.py drives it through random traces).
"""
from __future__ import annotations

from typing import List, Optional, Set

import numpy as np


class KVBlockPool:
    """Fixed pool of ``n_pages`` pages of ``page_size`` cache tokens each.

    Page ids are ``0 .. n_pages-1``.  (The device-side pool tensors carry one
    extra *trash* page at index ``n_pages`` that is never handed out: writes
    for inactive slots and reads through -1 table entries are routed there —
    see models/attention.py.)

    Invariants (asserted by :meth:`check`, driven through randomized
    200-operation alloc/share/fork/drop/release traces against a shadow
    model by ``tests/test_kv_pool_prop.py``):

      * every page is either FREE (on the freelist, refcount 0, no holders)
        or REFERENCED (off it, refcount == len(holders) >= 1) — never both,
        never neither;
      * refcounts never go negative, and occupancy counts a page shared by
        N slots exactly once (``used_count``);
      * a double free raises instead of corrupting the freelist, and a
        blind ``free`` of a still-shared page raises (shared pages are
        ``drop``ped per holder).

    The pool only does *accounting*; the complementary device-side invariant
    — a refcount>1 page is never written — is the scheduler's job (CoW in
    ``ContinuousEngine._ensure_pages``, trash-routing in the prefill
    scatter/chunk writes) and is asserted bit-for-bit by
    ``tests/test_prefix.py::test_cow_never_mutates_page_visible_to_another_slot``.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(f"need n_pages > 0 and page_size > 0, got {n_pages}/{page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO freelist: recently-freed pages are re-used first (their cache
        # lines are the ones most likely still resident).
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs = np.zeros((n_pages,), np.int64)  # 0 = free
        self._holders: List[Set[int]] = [set() for _ in range(n_pages)]

    # -- accounting --------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Physical pages in use — a page shared by N slots counts ONCE."""
        return self.n_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_count / self.n_pages

    @property
    def shared_count(self) -> int:
        """Live pages referenced by more than one slot."""
        return int((self._refs > 1).sum())

    def refcount(self, page: int) -> int:
        return int(self._refs[self._check_page(page)])

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache tokens."""
        return -(-max(n_tokens, 0) // self.page_size)

    def owned_by(self, owner: int) -> List[int]:
        """Pages ``owner`` holds a reference to (exclusive or shared)."""
        return [p for p in range(self.n_pages) if owner in self._holders[p]]

    def _check_page(self, page: int) -> int:
        page = int(page)
        if not (0 <= page < self.n_pages):
            raise ValueError(f"page {page} out of range [0, {self.n_pages})")
        return page

    def check(self) -> None:
        """Assert the pool's internal invariants (test/debug hook)."""
        free = set(self._free)
        assert len(free) == len(self._free), "freelist holds a duplicate page"
        for p in range(self.n_pages):
            refs, holders = int(self._refs[p]), self._holders[p]
            assert refs >= 0, f"page {p} refcount {refs} < 0"
            assert refs == len(holders), f"page {p}: refs {refs} != holders {holders}"
            if p in free:
                assert refs == 0, f"page {p} simultaneously free and referenced"
            else:
                assert refs >= 1, f"page {p} off the freelist with no references"
        assert self.free_count + self.used_count == self.n_pages

    # -- alloc / free ------------------------------------------------------
    def alloc(self, n: int, owner: int) -> Optional[List[int]]:
        """Pop ``n`` pages for ``owner`` (a slot id >= 0), all-or-nothing:
        either exactly ``n`` page ids come back (each refcount 1, held only
        by ``owner``) or None and the pool is untouched — the property that
        lets the scheduler admit by free-block count without ever
        half-admitting a request (``tests/test_kv_pool_prop.py`` fuzzes it;
        ``tests/test_paged.py::test_admission_by_free_block_count`` relies
        on it end-to-end)."""
        if owner < 0:
            raise ValueError(f"owner must be >= 0, got {owner}")
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
            self._holders[p] = {owner}
        return pages

    def share(self, pages, owner: int) -> None:
        """Add ``owner`` as a holder of each live page (refcount + 1): the
        prefix-sharing / parallel-sampling entry point.  Sharing a free page
        or a page the owner already holds raises — both mean the caller's
        table bookkeeping has diverged from the pool's."""
        if owner < 0:
            raise ValueError(f"owner must be >= 0, got {owner}")
        pages = [self._check_page(p) for p in pages]
        for p in pages:
            if self._refs[p] == 0:
                raise ValueError(f"cannot share free page {p}")
            if owner in self._holders[p]:
                raise ValueError(f"owner {owner} already holds page {p}")
        for p in pages:
            self._refs[p] += 1
            self._holders[p].add(owner)

    def drop(self, page: int, owner: int) -> bool:
        """Remove ``owner``'s reference to ``page``; free it if that was the
        last reference.  Returns True iff the page was freed."""
        page = self._check_page(page)
        if self._refs[page] == 0:
            raise ValueError(f"double free of page {page}")
        if owner not in self._holders[page]:
            raise ValueError(f"owner {owner} does not hold page {page}")
        self._holders[page].discard(owner)
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def fork(self, page: int, owner: int) -> Optional[int]:
        """Copy-on-write split: give ``owner`` a fresh private page in place
        of its reference to shared ``page``.  Returns the new page id (the
        caller must copy the device-side contents old -> new and remap its
        block table), or None when the pool is dry — the scheduler then
        preempts to make room.  The old page keeps its other holders."""
        page = self._check_page(page)
        if owner not in self._holders[page]:
            raise ValueError(f"owner {owner} does not hold page {page}")
        got = self.alloc(1, owner)
        if got is None:
            return None
        self.drop(page, owner)
        return got[0]

    def free(self, pages) -> None:
        """Return exclusively-held pages to the pool.  Freeing an already-free
        page raises (a double free means two slots think they own the same
        page); freeing a page with other holders raises too — shared pages
        must be ``drop``ed per holder, never blind-freed."""
        for p in pages:
            p = self._check_page(p)
            if self._refs[p] == 0:
                raise ValueError(f"double free of page {p}")
            if self._refs[p] > 1:
                raise ValueError(
                    f"page {p} still referenced by {sorted(self._holders[p])}; "
                    "shared pages are dropped per holder, not freed"
                )
            self._refs[p] = 0
            self._holders[p] = set()
            self._free.append(p)

    def commit_fork_run(self, bases, owner: int) -> List[int]:
        """Commit a run of copy-on-write forks by REFCOUNT HANDOFF: for each
        base page the speculative window forked, drop ``owner``'s reference
        to the base — the fork page (already alloc'd to ``owner``) takes its
        place in the block table, so the owner's page count is conserved.
        Returns the bases actually freed (refcount hit zero: the base was
        shared at fork time, so this is normally empty, but a sharer can
        depart mid-speculation).  Callers must evict freed ids from the
        prefix index and device-invalidate them before reuse."""
        freed = []
        for p in bases:
            if self.drop(p, owner):
                freed.append(p)
        return freed

    def drop_fork_run(self, forks, owner: int) -> List[int]:
        """Roll back a rejected speculative suffix: free a run of fork pages
        that were alloc'd for the verify window and whose contents were
        rejected.  Every page must be a PRIVATE fork of ``owner`` (refcount
        exactly 1) — a shared or foreign page here means the scheduler
        committed it into a table or the prefix index, and freeing it would
        corrupt another sequence.  Returns the freed pages (always all of
        them); callers must device-invalidate them before reuse."""
        for p in forks:
            p = self._check_page(p)
            if self._refs[p] != 1 or owner not in self._holders[p]:
                raise ValueError(
                    f"page {p} is not a private fork of owner {owner} "
                    f"(refs={int(self._refs[p])}, "
                    f"holders={sorted(self._holders[p])})"
                )
        out = []
        for p in forks:
            self.drop(p, owner)
            out.append(p)
        return out

    def release(self, owner: int) -> List[int]:
        """Drop every page reference ``owner`` holds (request completion or
        preemption) and return the pages actually FREED — i.e. those whose
        refcount hit zero.  Pages another slot still references are decrefed
        and stay live (copy-on-write sharing survives the departure — the
        old exclusive owner-tag model yanked them from under sharers;
        ``tests/test_prefix.py::test_preempted_sharer_decrefs_not_frees`` is
        the regression).  Safe to call with a stale/unknown owner (drops
        nothing).  Callers must evict the RETURNED ids from the prefix index
        and device-invalidate them (``paged_reset_pages``) before reuse."""
        freed = []
        for p in self.owned_by(owner):
            if self.drop(p, owner):
                freed.append(p)
        return freed


class BlockTables:
    """Static-shape per-slot block tables: an int32 ``[slots, max_pages]``
    array, -1 for unmapped entries.  Fixed shape is what keeps the jitted
    paged decode step from recompiling as sequences grow/shrink: the device
    side always sees the same ``[slots, max_pages]`` operand, and -1 entries
    read the trash page (masked by its ``pos == -1`` fill).

    Sharing lives entirely in the pool's refcounts: a table row is just
    pointers, so prefix sharing means two rows holding the same page id and
    copy-on-write means rewriting one entry (``set_entry``) after the engine
    copies the device page.

    Invariant: a row's mapped entries are a prefix (position order) — pages
    are appended as the sequence grows and only ever remapped in place
    (CoW) or reset wholesale; the decode/prefill kernels index the row by
    ``position // page_size`` and rely on it.  ``tests/test_paged.py``
    exercises growth/reset; the scheduler fuzz in ``tests/test_prefix.py``
    drives remapping under sharing."""

    def __init__(self, slots: int, max_pages: int):
        if slots <= 0 or max_pages <= 0:
            raise ValueError(f"need slots > 0 and max_pages > 0, got {slots}/{max_pages}")
        self.max_pages = int(max_pages)
        self.table = np.full((slots, max_pages), -1, np.int32)

    def n_mapped(self, slot: int) -> int:
        return int((self.table[slot] >= 0).sum())

    def append(self, slot: int, pages) -> None:
        """Map ``pages`` into the next unmapped entries of ``slot``'s row."""
        start = self.n_mapped(slot)
        pages = list(pages)
        if start + len(pages) > self.max_pages:
            raise ValueError(
                f"slot {slot} table overflow: {start}+{len(pages)} > {self.max_pages}"
            )
        self.table[slot, start : start + len(pages)] = np.asarray(pages, np.int32)

    def set_entry(self, slot: int, idx: int, page: int) -> None:
        """Remap one mapped entry (copy-on-write divergence)."""
        if self.table[slot, idx] < 0:
            raise ValueError(f"slot {slot} entry {idx} is unmapped")
        self.table[slot, idx] = page

    def copy_row(self, dst: int, src: int) -> None:
        """Point ``dst``'s table at the same pages as ``src`` (parallel
        sampling fork — the pool's ``share`` must incref them)."""
        self.table[dst] = self.table[src]

    def reset(self, slot: int) -> None:
        self.table[slot] = -1

    def row(self, slot: int) -> np.ndarray:
        return self.table[slot]
