"""Radix prefix cache over the paged FP8-e4m3 KV pool.

Counterpart of ``repro.serve.prefix_cache``: host-only bookkeeping over
the allocator's refcounts, so the port keeps the reference's code as it
is.  The device work it implies (the copy-on-write page copy) is the
engine's ``paged_kv.copy_page``.

Production traffic is dominated by shared prompt prefixes — system prompts,
few-shot headers, multi-turn history.  The paper's per-row po2 scales make
FP8 KV pages deterministic given (tokens, positions, chunk geometry): the
quantize is idempotent (Eq. 5-8), so a page written once for a prefix is
bit-for-bit the page any identical prefix would write, i.e. pages are
content-addressable and safely shareable.

This module maps FULL-PAGE-ALIGNED token prefixes to refcounted page ids in
the existing pool through a radix tree at token-BLOCK granularity (one tree
edge element == one ``page_size`` token block == one page id):

  * ``lookup(prompt)`` walks the tree and returns the longest cached
    page-aligned prefix: the request stitches those SHARED pages (incref)
    ahead of freshly allocated tail pages, starts prefill at the matched
    length, and skips the matched prefill FLOPs entirely.  A whole-prompt
    hit is capped at ``len(prompt) - 1`` (the last token must be recomputed
    for its logits) and the final cached page is returned as copy-on-write:
    the engine duplicates it so the recomputed row lands in a private page.
  * ``insert(prompt, pages)`` is called once a request's prefill completes:
    blocks already on the tree are skipped (their pages stay canonical),
    the new suffix is recorded and its pages gain a cache reference, so
    they survive the owner request finishing.
  * Eviction is LRU over UNREFERENCED radix leaves: when the free list runs
    dry (``alloc_pages``), the least-recently-matched leaf trims the
    maximal tail of pages only the cache still references (refcount 1);
    pages pinned by resident requests are never victims, so a shared
    prefix in use can never be yanked.

The tree compresses paths rtp-llm/SGLang-style: one node holds a run of
blocks from a single insert; a later insert diverging mid-edge splits the
node at the (block-aligned) divergence point.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.paged_kv import PageAllocator

Block = Tuple[int, ...]


@dataclasses.dataclass
class PrefixMatch:
    """One lookup result.  `pages` are the cached pages covering the match
    IN ORDER; `tokens` is the prefill start position (`len(pages) *
    page_size`, except a whole-prompt hit where it is `len(prompt) - 1`);
    `cow` marks that the LAST page must be copied before the request may
    write its recomputed final-token row into it."""
    pages: List[int]
    tokens: int
    cow: bool = False


class RadixNode:
    __slots__ = ("blocks", "pages", "children", "parent", "last_used")

    def __init__(self, blocks: List[Block], pages: List[int],
                 parent: Optional["RadixNode"]):
        self.blocks = blocks           # edge label: consecutive token blocks
        self.pages = pages             # parallel page ids, one per block
        self.children: Dict[Block, "RadixNode"] = {}   # keyed by first block
        self.parent = parent
        self.last_used = 0

    def is_leaf(self) -> bool:
        return not self.children


class PrefixCache:
    """Radix tree of page-aligned prompt prefixes -> shared KV pages."""

    def __init__(self, page_size: int, telemetry=None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        if telemetry is None:
            from repro_torch.obs.sink import null_telemetry
            telemetry = null_telemetry()
        self.tel = telemetry
        self.root = RadixNode([], [], None)
        self._clock = itertools.count(1)
        self.n_cached_pages = 0
        self.n_hits = 0
        self.n_lookups = 0
        self.hit_tokens = 0
        self.n_evictions = 0
        self.n_evicted_pages = 0

    # -- internals ---------------------------------------------------------
    def _blocks(self, tokens: Sequence[int]) -> List[Block]:
        ps = self.page_size
        return [tuple(tokens[i * ps:(i + 1) * ps])
                for i in range(len(tokens) // ps)]

    def _walk(self, blocks: List[Block], touch: bool):
        """Longest-prefix walk.  Returns (node, n_node_blocks_matched,
        pages, n_blocks_matched_total): `node` is the deepest node entered,
        with its first `n_node_blocks_matched` edge blocks matched (< len
        means the walk died mid-edge)."""
        node, i, pages = self.root, 0, []
        now = next(self._clock)
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                return node, len(node.blocks), pages, i
            m = 0
            while m < len(child.blocks) and i + m < len(blocks) \
                    and child.blocks[m] == blocks[i + m]:
                m += 1
            pages.extend(child.pages[:m])
            i += m
            if touch:
                child.last_used = now
            if m < len(child.blocks):
                return child, m, pages, i
            node = child
        return node, len(node.blocks), pages, i

    def _iter_nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())

    # -- queries -----------------------------------------------------------
    def match_tokens(self, tokens: Sequence[int]) -> int:
        """Cached-prefix length in tokens WITHOUT touching LRU clocks or hit
        counters (the router's peek)."""
        _, _, pages, _ = self._walk(self._blocks(tokens), touch=False)
        return min(len(pages) * self.page_size, max(len(tokens) - 1, 0))

    def lookup(self, tokens: Sequence[int]) -> Optional[PrefixMatch]:
        """Longest cached page-aligned prefix of `tokens`, or None.
        Refreshes LRU clocks along the matched path but counts NO hit
        stats — admission may still fail on budget/slots, so the scheduler
        calls ``record_admitted`` exactly once per admitted request."""
        _, _, pages, _ = self._walk(self._blocks(tokens), touch=True)
        if not pages:
            return None
        matched = len(pages) * self.page_size
        cow = matched >= len(tokens)
        if cow:
            # whole-prompt hit: recompute the last token for its logits; its
            # KV row lands in the final cached page -> copy-on-write
            matched = len(tokens) - 1
        if matched <= 0:
            return None
        return PrefixMatch(pages=list(pages), tokens=matched, cow=cow)

    def match_pages(self, tokens: Sequence[int]) -> List[int]:
        """Cached pages covering `tokens`' longest full-block prefix, with
        NO cow capping and no hit accounting (LRU clocks are refreshed —
        the pages are about to be pinned).  The disaggregation adopt path
        uses this to dedupe a migration against the RECEIVER's cache: any
        block the receiver already holds is shared by incref instead of
        shipped over the wire, and because po2-quantized pages are
        content-addressable the local page is bit-identical to the one the
        donor would have sent."""
        _, _, pages, _ = self._walk(self._blocks(tokens), touch=True)
        return list(pages)

    def record_admitted(self, match: Optional[PrefixMatch]) -> None:
        """Per-request hit accounting, called once per successful
        admission (with match=None for a miss)."""
        self.n_lookups += 1
        if match is None:
            return
        self.n_hits += 1
        self.hit_tokens += match.tokens
        self.tel.counter("prefix_hits").inc()
        self.tel.counter("prefix_hit_tokens").inc(match.tokens)

    # -- mutation ----------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               allocator: PageAllocator) -> int:
        """Record `tokens`' full-block prefix, mapping each NEW block to the
        request's corresponding page (the cache increfs those — they outlive
        the request).  Blocks already on the tree keep their existing
        canonical pages (a concurrent miss's duplicate pages stay private
        and die with their request).  Returns the number of newly cached
        pages."""
        blocks = self._blocks(tokens)
        if len(pages) < len(blocks):
            raise ValueError(f"insert needs one page per full block: "
                             f"{len(pages)} pages < {len(blocks)} blocks")
        node, m, _, i = self._walk(blocks, touch=True)
        if i >= len(blocks):
            return 0
        if m < len(node.blocks):
            self._split(node, m)
        tail = RadixNode(list(blocks[i:]), list(pages[i:len(blocks)]), node)
        tail.last_used = next(self._clock)
        allocator.incref(tail.pages)
        node.children[tail.blocks[0]] = tail
        self.n_cached_pages += len(tail.pages)
        self.tel.gauge("shared_pages").set(self.n_cached_pages)
        return len(tail.pages)

    def _split(self, node: RadixNode, m: int) -> None:
        """Split `node`'s edge after its m-th block: node keeps the prefix,
        a new child carries the suffix (and inherits node's children)."""
        assert 0 < m < len(node.blocks)
        suffix = RadixNode(node.blocks[m:], node.pages[m:], node)
        suffix.children = node.children
        for c in suffix.children.values():
            c.parent = suffix
        suffix.last_used = node.last_used
        node.blocks = node.blocks[:m]
        node.pages = node.pages[:m]
        node.children = {suffix.blocks[0]: suffix}

    # -- eviction ----------------------------------------------------------
    def _evict_one(self, allocator: PageAllocator) -> int:
        """Trim the LRU-most leaf's maximal unreferenced tail (pages whose
        only reference is the cache's own); drops the leaf entirely when the
        whole edge trims.  Returns pages freed (0 => nothing evictable)."""
        best = None
        for n in self._iter_nodes():
            if n.is_leaf() and allocator.refcount(n.pages[-1]) == 1 \
                    and (best is None or n.last_used < best.last_used):
                best = n
        if best is None:
            return 0
        k = len(best.pages)
        while k > 0 and allocator.refcount(best.pages[k - 1]) == 1:
            k -= 1
        dropped = best.pages[k:]
        allocator.decref(dropped)
        del best.blocks[k:]
        del best.pages[k:]
        if k == 0:
            parent = best.parent
            for key, c in list(parent.children.items()):
                if c is best:
                    del parent.children[key]
        self.n_cached_pages -= len(dropped)
        self.n_evictions += 1
        self.n_evicted_pages += len(dropped)
        self.tel.counter("cache_evictions").inc()
        self.tel.gauge("shared_pages").set(self.n_cached_pages)
        return len(dropped)

    def alloc_pages(self, allocator: PageAllocator,
                    n: int) -> Optional[List[int]]:
        """Allocate n pages, evicting LRU unreferenced radix leaves while
        the free list is dry.  None once nothing cache-held remains to
        evict (the caller falls back to scheduler eviction)."""
        got = allocator.alloc(n)
        while got is None:
            if self._evict_one(allocator) == 0:
                return None
            got = allocator.alloc(n)
        return got

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {"prefix_lookups": self.n_lookups,
                "prefix_hits": self.n_hits,
                "prefix_hit_tokens": self.hit_tokens,
                "shared_pages": self.n_cached_pages,
                "cache_evictions": self.n_evictions,
                "cache_evicted_pages": self.n_evicted_pages}

    def check_invariants(self, allocator: PageAllocator) -> None:
        """Structural invariants (tests call this after every mutation):
        every node's pages are live with refcount >= 1, page count matches
        block count, children are keyed by their first block, and the total
        page tally matches ``n_cached_pages``."""
        total = 0
        for n in self._iter_nodes():
            assert n.blocks and len(n.blocks) == len(n.pages), \
                f"edge/page mismatch: {len(n.blocks)} vs {len(n.pages)}"
            assert all(allocator.refcount(p) >= 1 for p in n.pages), \
                "cached page without a live reference"
            for key, c in n.children.items():
                assert c.blocks[0] == key and c.parent is n
            total += len(n.pages)
        for key, c in self.root.children.items():
            assert c.blocks[0] == key and c.parent is self.root
        assert total == self.n_cached_pages, \
            f"page tally {total} != n_cached_pages {self.n_cached_pages}"
