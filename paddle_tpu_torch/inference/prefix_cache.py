"""Radix prefix cache over the paged block pool (the port of
`paddle_tpu/inference/prefix_cache.py`).

Committed KV becomes REUSABLE: a radix tree whose nodes each pin ONE
physical block of the `BlockCacheManager` pool, keyed by the block's
token content.

- **publish** (at request finish / preemption): every full block of a
  committed prompt + response walks into the tree; new paths incref the
  sequence's own blocks (the tree holds one lease per node), so the KV
  survives the sequence's `free`.
- **lease** (at admission): a new request walks the tree with its
  context tokens and adopts the deepest cached path (one lease per
  block, no prefill for those tokens); chunked prefill resumes from the
  first uncached token. The hit is capped at `len(context) - 1` (`_cap`):
  the model must still run one token to produce first-token logits. The
  last matched node may match PARTIALLY (the request diverges mid-block):
  the block is leased shared, and the first divergent `append_tokens`
  copies it on write, so siblings keep their bytes.
- **evict** (under pool pressure): the manager calls `evict(n)` before
  raising `KVCacheExhausted`; unpinned leaves (only the tree holds the
  block) go in LRU order, leaf-up. A block leased by any live sequence
  is never reclaimed.

The tree is host bookkeeping only; sharing is expressed through block
tables, the granularity the ragged paged-attention kernel reads. Its
decisions (walk, caps, LRU ties by block id) are the JAX package's, so
the two packages' trees stay equal op for op.

Counters go to the port's monitor under `serving.prefix_cache.*`
(hits / misses / hit_tokens / evictions; `cow_copies` from the manager)
and stay on the instance (`stats()`).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..framework import monitor as _monitor
from .cache import BlockCacheManager

__all__ = ["RadixPrefixCache"]


class _Node:
    """One cached block: `tokens` (its content key, up to block_size
    ids), the pinned physical `block`, children keyed by their full
    token tuple, and an LRU `stamp`."""

    __slots__ = ("tokens", "block", "children", "first", "parent",
                 "stamp")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: "_Node"):
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        # first-token index over children: bounds the partial-match
        # scan to same-first-token candidates instead of every child
        # (the root grows one child per distinct cached opening block)
        self.first: Dict[int, List["_Node"]] = {}
        self.parent = parent
        self.stamp = 0

    def add_child(self, child: "_Node") -> None:
        self.children[child.tokens] = child
        self.first.setdefault(child.tokens[0], []).append(child)

    def drop_child(self, child: "_Node") -> None:
        del self.children[child.tokens]
        sibs = self.first[child.tokens[0]]
        sibs.remove(child)
        if not sibs:
            del self.first[child.tokens[0]]


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    k = 0
    while k < n and a[k] == b[k]:
        k += 1
    return k


class RadixPrefixCache:
    """Radix/prefix tree over `BlockCacheManager` blocks.

    Register it as the manager's reclaimer
    (`manager.set_reclaimer(tree)`) so cached blocks surrender under
    pool pressure instead of tripping `KVCacheExhausted`.
    """

    def __init__(self, manager: BlockCacheManager,
                 max_blocks: Optional[int] = None):
        """`max_blocks` caps how many pool blocks the tree may pin
        (None = unbounded; the LRU + reclaimer keep it honest under
        pressure either way)."""
        self.manager = manager
        self.max_blocks = max_blocks
        self._root = _Node((), -1, None)  # sentinel: no block
        self._by_block: Dict[int, _Node] = {}
        # blocks whose ONLY lease is the tree's (refcount 1) — kept
        # current by the manager's refcount-transition notifications
        # (`note_ref`), so `reclaimable()` is O(1) on the per-submit
        # admission path and eviction scans candidates, not the tree
        self._unpinned: set = set()
        self._tick = itertools.count(1)
        # per-instance counters (monitor names are process-global; the
        # fleet router reads THESE for per-replica hit rates)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    # ---- introspection ----
    @property
    def num_nodes(self) -> int:
        return len(self._by_block)

    @property
    def cached_blocks(self) -> int:
        return len(self._by_block)

    def blocks(self) -> set:
        """Physical blocks the tree currently pins (leak audits)."""
        return set(self._by_block)

    def block_ref_counts(self) -> Dict[int, int]:
        """block -> leases held by the TREE (always 1 per node) — the
        `external` input of `BlockCacheManager.check_consistency`."""
        return {b: 1 for b in self._by_block}

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "hit_rate": round(self.hit_rate(), 4),
                "nodes": self.num_nodes,
                "evictions": self.evictions,
                "cow_copies": self.manager.cow_copies}

    # ---- the walk ----
    def _walk(self, toks: List[int], touch: bool):
        """Longest cached prefix of `toks`: full-block child hops, then
        one partial match against the divergent level's children.
        Returns (blocks, hit_tokens, last_node)."""
        bs = self.manager.block_size
        node = self._root
        blocks: List[int] = []
        hit = 0
        stamp = next(self._tick) if touch else 0
        path = []
        while len(toks) - hit >= bs:
            key = tuple(toks[hit:hit + bs])
            child = node.children.get(key)
            if child is None:
                break
            node = child
            blocks.append(child.block)
            hit += bs
            path.append(child)
        # partial match: the deepest node whose content starts with the
        # request's remaining tokens buys up to block_size - 1 more
        # cached tokens (COW covers the divergent continuation); only
        # children sharing the first token are candidates
        rem = toks[hit:]
        if rem:
            best, best_k = None, 0
            for child in node.first.get(rem[0], ()):
                k = _common_prefix(child.tokens, rem)
                if k > best_k:
                    best, best_k = child, k
            if best is not None:
                blocks.append(best.block)
                hit += best_k
                path.append(best)
        if touch:
            for n in path:
                n.stamp = stamp
        return blocks, hit, node

    def _cap(self, toks: List[int], blocks: List[int], hit: int):
        """Apply the lease caps to a raw walk result: leave >= 1 token
        to run (first-token logits), respect `max_blocks_per_seq`, and
        drop a trailing block the capped hit no longer reaches. ONE
        shared implementation, so `match_blocks`' admission estimate
        can never diverge from what `lease` actually adopts."""
        mgr = self.manager
        hit = min(hit, len(toks) - 1)
        while len(blocks) > mgr.max_blocks_per_seq:
            blocks.pop()
            hit = min(hit, len(blocks) * mgr.block_size)
        while blocks and hit <= (len(blocks) - 1) * mgr.block_size:
            blocks.pop()
        if hit <= 0 or not blocks:
            return [], 0
        return blocks, hit

    def match_tokens(self, tokens) -> int:
        """Cached-prefix length for `tokens` WITHOUT leasing. Same walk
        and caps as `lease`."""
        toks = np.asarray(tokens).reshape(-1).tolist()
        if not toks:
            return 0
        blocks, hit, _ = self._walk(toks, touch=False)
        _blocks, hit = self._cap(toks, blocks, hit)
        return hit

    def match_blocks(self, tokens) -> int:
        """EXACTLY the blocks a `lease` of `tokens` would adopt (0 on a
        miss) — same walk, same caps, so the scheduler's admission
        headroom estimate cannot under-price the remaining need."""
        toks = np.asarray(tokens).reshape(-1).tolist()
        if not toks:
            return 0
        blocks, hit, _ = self._walk(toks, touch=False)
        blocks, _hit = self._cap(toks, blocks, hit)
        return len(blocks)

    def match_export(self, tokens) -> Tuple[List[int], int]:
        """``(blocks, hit_tokens)`` for the FULL-block cached prefix of
        `tokens` (the walk a cross-replica prefix export takes). The
        lease caps don't apply, and the partial-tail match is dropped
        because a tree only stores full blocks; `max_blocks_per_seq`
        still bounds the result."""
        toks = np.asarray(tokens).reshape(-1).tolist()
        if not toks:
            return [], 0
        blocks, hit, _ = self._walk(toks, touch=False)
        bs = self.manager.block_size
        n_full = min(hit // bs, len(blocks),
                     self.manager.max_blocks_per_seq)
        return blocks[:n_full], n_full * bs

    # ---- lease / publish / evict ----
    def lease(self, seq_id: int, tokens) -> int:
        """Adopt the deepest cached prefix of `tokens` for `seq_id`
        (refcount bump per block; ZERO prefill for the hit). Returns the
        hit length in tokens — 0 means miss and NO allocation was made
        (the caller falls back to `allocate`). The hit is capped at
        `len(tokens) - 1` so at least one token still runs through the
        model (first-token logits), and at `max_blocks_per_seq`."""
        toks = np.asarray(tokens).reshape(-1).tolist()
        mgr = self.manager
        if not toks:
            self.misses += 1
            _monitor.inc("serving.prefix_cache.misses")
            return 0
        blocks, hit, _ = self._walk(toks, touch=True)
        blocks, hit = self._cap(toks, blocks, hit)
        if hit <= 0:
            self.misses += 1
            _monitor.inc("serving.prefix_cache.misses")
            return 0
        mgr.adopt(seq_id, blocks, hit)
        self.hits += 1
        self.hit_tokens += hit
        _monitor.inc("serving.prefix_cache.hits")
        _monitor.inc("serving.prefix_cache.hit_tokens", hit)
        return hit

    def publish(self, seq_id: int, tokens) -> int:
        """Insert every FULL block of `tokens` (a committed context
        whose KV sits in `seq_id`'s leased blocks) into the tree,
        increffing newly-pinned blocks. Existing nodes win ties (their
        KV is identical by content). Returns nodes added."""
        toks = np.asarray(tokens).reshape(-1).tolist()
        mgr = self.manager
        bs = mgr.block_size
        table = mgr.blocks_of(seq_id)
        n_full = min(len(toks) // bs, len(table))
        node = self._root
        added = 0
        stamp = next(self._tick)
        for j in range(n_full):
            key = tuple(toks[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                if self.max_blocks is not None \
                        and len(self._by_block) >= self.max_blocks:
                    if self.evict(1) == 0:
                        break           # at cap and nothing reclaimable
                    if node is not self._root \
                            and node.block not in self._by_block:
                        break           # eviction took our attach point
                block = table[j]
                if block in self._by_block:
                    # this physical block already backs ANOTHER path's
                    # node (we leased it there); content under two keys
                    # would double-lease — stop publishing this branch
                    break
                child = _Node(key, block, node)
                node.add_child(child)
                self._by_block[block] = child
                mgr.incref(block)
                added += 1
            child.stamp = stamp
            node = child
        return added

    def note_ref(self, block: int, n: int) -> None:
        """Manager callback on a 1<->2 refcount transition of a cached
        block: track whether the tree is its only lease. O(1)."""
        if block in self._by_block:
            if n == 1:
                self._unpinned.add(block)
            else:
                self._unpinned.discard(block)

    def reclaimable(self) -> int:
        """Blocks only the tree holds — free-on-demand capacity. An
        UPPER bound on what one `evict` pass frees (an unpinned inner
        node under a pinned leaf waits for the leaf); over-admission on
        the gap degrades through the normal exhaustion/preempt ladder.
        O(1): the set is maintained by refcount-transition callbacks."""
        return len(self._unpinned)

    def evict(self, n_blocks: int) -> int:
        """Free up to `n_blocks` unpinned cached blocks, LRU-first,
        leaf-up. Blocks with any non-tree lease (refcount > 1) are never
        touched. Returns blocks actually freed. Cost: a heap over the
        UNPINNED candidates only (O((U + freed) log U)), not a tree
        scan per freed block."""
        mgr = self.manager
        heap = []
        for b in self._unpinned:
            nd = self._by_block[b]
            if not nd.children:
                heap.append((nd.stamp, b))
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_blocks:
            _stamp, b = heapq.heappop(heap)
            nd = self._by_block.get(b)
            if nd is None or nd.children or mgr.ref_count(b) != 1:
                continue               # stale entry
            parent = nd.parent
            self._remove(nd)
            freed += 1
            if parent is not self._root and not parent.children \
                    and mgr.ref_count(parent.block) == 1:
                heapq.heappush(heap, (parent.stamp, parent.block))
        return freed

    def _remove(self, node: _Node) -> None:
        node.parent.drop_child(node)
        del self._by_block[node.block]
        self._unpinned.discard(node.block)
        self.manager.release_block(node.block)
        self.evictions += 1
        _monitor.inc("serving.prefix_cache.evictions")

    def clear(self) -> int:
        """Drop every node (releasing the tree's leases); returns the
        number released. Used when the engine (and its device KV) is
        rebuilt — the tree's bytes died with it."""
        n = 0
        for node in list(self._by_block.values()):
            self.manager.release_block(node.block)
            n += 1
        self._by_block.clear()
        self._unpinned.clear()
        self._root.children.clear()
        self._root.first.clear()
        return n
