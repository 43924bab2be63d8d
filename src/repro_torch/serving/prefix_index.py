"""Radix index over full-page token chunks: prompt prefix -> physical pages.

A verbatim copy of the JAX package's ``repro/serving/prefix_index.py``
(plain Python), so the port imports nothing of ``repro``; the JAX package's
index tests run against both copies (``tests/test_torch_prefix.py``).

Heavy serving traffic repeats itself — system prompts, few-shot preambles,
retrieval templates — so many concurrent requests begin with the same token
prefix.  Under paged KV serving (serving/kv_pool.py) that prefix's K/V is
bit-identical across requests: attention K/V depend only on (token id,
absolute position) and every request's context starts at position 0, so a
shared prefix occupies identical page contents.  Block tables already make
the sharing *representable* (two rows pointing at one page); this index
makes it *findable*: a trie keyed by ``page_size``-token chunks maps every
indexed full-page prompt prefix to the physical page holding it.

Only FULL pages are indexed — a partially-filled page also holds whatever
the owning sequence appends next, which is exactly where divergence happens
(copy-on-write territory, handled by the scheduler, not the index).

The index holds no references of its own: a mapping is valid precisely while
its page is live in the pool, and the engine calls ``evict_pages`` whenever
pages are freed.  This keeps lifetime trivial (no cache-retention policy:
pages persist while at least one slot holds them, and the pool drains to
empty when traffic does) at the cost of losing reuse across idle gaps — a
retention policy over free pages is a natural follow-on.

Eviction of a mid-chain node leaves a *hole*: descendants may still hold
live pages, but a lookup must stop at the hole because a prefix match is
only as long as its unbroken page chain.  Holes with no descendants are
pruned so the trie's size tracks live pages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("chunk", "page", "parent", "children")

    def __init__(self, chunk: Tuple[int, ...], parent: Optional["_Node"]):
        self.chunk = chunk
        self.page: Optional[int] = None  # physical page holding this chunk's K/V
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}


class PrefixIndex:
    """Trie of ``page_size``-token chunks -> live physical page ids.

    Caller contract (the index cannot check these itself; the randomized
    scheduler fuzz in ``tests/test_prefix.py`` and the progressive-
    registration tests in ``tests/test_chunked.py`` enforce them through the
    engine):

      * **an indexed page already holds its K/V** — chunked prefill inserts
        each full page only after its chunk is written, because a lookup may
        hand the page to a sharer on the very next admission;
      * **eviction tracks the pool** — ``evict_pages`` must be called with
        exactly the ids ``KVBlockPool.release`` reports freed, so a mapping
        is live iff its page is; the index drains to empty when the pool
        does (asserted at the end of every fuzz run);
      * only FULL pages are ever inserted; a partial page also holds
        whatever its owner appends next (CoW territory, not shareable).
    """

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"need page_size > 0, got {page_size}")
        self.page_size = int(page_size)
        self._root = _Node((), None)
        self._by_page: Dict[int, _Node] = {}

    def __len__(self) -> int:
        """Number of live (chunk-path -> page) mappings."""
        return len(self._by_page)

    def _chunks(self, tokens: Sequence[int], n: int):
        ps = self.page_size
        for c in range(n):
            yield tuple(int(t) for t in tokens[c * ps : (c + 1) * ps])

    # ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register the full-page prefix chunks of ``tokens`` as living in
        ``pages`` (``pages[c]`` holds chunk ``c``).  Partial trailing chunks
        are ignored; chunks already mapped keep their existing (live) page —
        first writer wins, and the duplicate physical copy simply never gets
        shared.  Returns the number of newly-registered mappings."""
        n_full = min(len(tokens) // self.page_size, len(pages))
        node, added = self._root, 0
        for c, chunk in enumerate(self._chunks(tokens, n_full)):
            child = node.children.get(chunk)
            if child is None:
                child = node.children[chunk] = _Node(chunk, node)
            if child.page is None:
                page = int(pages[c])
                if page in self._by_page:
                    raise ValueError(f"page {page} already indexed at another path")
                child.page = page
                self._by_page[page] = child
                added += 1
            node = child
        return added

    def lookup(self, tokens: Sequence[int], *, max_tokens: Optional[int] = None) -> List[int]:
        """Longest unbroken chain of indexed full-page chunks matching the
        head of ``tokens``; returns the physical pages in chunk order.
        ``max_tokens`` caps the match (admission passes ``len(ctx) - 1`` so
        at least one context token is left to prefill for last-token
        logits)."""
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        n_full = max(limit, 0) // self.page_size
        node, pages = self._root, []
        for chunk in self._chunks(tokens, n_full):
            child = node.children.get(chunk)
            if child is None or child.page is None:  # miss or evicted hole
                break
            pages.append(child.page)
            node = child
        return pages

    def evict_pages(self, pages: Sequence[int]) -> int:
        """Remove mappings whose page was freed.  Descendant mappings stay
        (their pages are still live) but become unreachable until the hole is
        re-filled by a future insert of the same chunk path.  Returns the
        number of mappings removed."""
        removed = 0
        for p in pages:
            node = self._by_page.pop(int(p), None)
            if node is None:
                continue
            node.page = None
            removed += 1
            # prune childless holes up the chain
            while node.parent is not None and node.page is None and not node.children:
                node.parent.children.pop(node.chunk, None)
                node = node.parent
        return removed
