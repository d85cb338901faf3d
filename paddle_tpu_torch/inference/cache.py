"""Paged KV-cache block management (host side), the port of
`paddle_tpu/inference/cache.py`'s `BlockCacheManager`.

Device memory is a pool of fixed-size blocks; each sequence holds a block
table mapping logical block index -> physical block id. Allocation and
free are O(1) host bookkeeping, so the device pool never reallocates.

Physical blocks are REFERENCE COUNTED: several leases (sequences, or the
radix prefix tree in `inference/prefix_cache.py`) may point at the same
physical block, which is how a shared system prompt's KV is prefilled
once and attended by every request that carries it. A block returns to
the free list only when its last lease drops. A write into a shared
block copies it first (COPY-ON-WRITE, `append_tokens`): the writer gets a
private copy (the `cow_hook` copies the device-side KV), every other
lease keeps the original bytes.

Exhaustion is a scheduling event, not a crash: `allocate` and
`append_tokens` raise the typed `KVCacheExhausted` (pool empty) or
`SequenceTooLong` (per-sequence block cap), which the serving scheduler
consumes to queue or preempt requests. Before raising `KVCacheExhausted`
the manager asks its registered `reclaimer` (the prefix tree) to evict
unpinned cached blocks.

Block ids come off the free list in the JAX package's order, so the two
packages' integer state matches exactly. The `serve.cache` fault site is
the port's own registry (`resilience/faults.py`); unlike the JAX module,
this one looks nothing up in `sys.modules`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..framework import monitor
from ..resilience import faults

__all__ = ["BlockCacheManager", "KVCacheExhausted", "SequenceTooLong"]


class KVCacheExhausted(RuntimeError):
    """The physical block pool has no free block.

    Recoverable by design: the serving scheduler catches this to delay
    admission or preempt a running sequence (blocks come back via `free`).
    """

    def __init__(self, need: int, free: int, total: int):
        self.need = need
        self.free = free
        self.total = total
        super().__init__(
            f"KV cache pool exhausted: need {need} block(s), "
            f"{free}/{total} free")


class SequenceTooLong(ValueError):
    """A single sequence asked for more than `max_blocks_per_seq` blocks.

    Unlike `KVCacheExhausted` this is not recoverable by waiting — the
    request can never fit and must be rejected (or its generation capped).
    """

    def __init__(self, need_blocks: int, max_blocks: int):
        self.need_blocks = need_blocks
        self.max_blocks = max_blocks
        super().__init__(
            f"sequence needs {need_blocks} blocks > max_blocks_per_seq "
            f"{max_blocks}")


class BlockCacheManager:
    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._lens: Dict[int, int] = {}
        # physical block -> lease count, for every block OUT of the free
        # list (1 everywhere in a workload without sharing)
        self._refs: Dict[int, int] = {}
        self._guard_ids: set = set()   # guard seqs, so utilization() is
        #                                O(#guards) on the step path
        # `cow_hook(src, dst)` copies the device-side KV of one block
        # (engines provide `copy_kv_block`; None = bookkeeping only);
        # `reclaimer` frees unpinned cached blocks before
        # KVCacheExhausted surfaces
        self._cow_hook: Optional[Callable[[int, int], None]] = None
        self._reclaimer = None
        self.cow_copies = 0            # lifetime COW count (this manager)
        # KV byte geometry (engines register it via `set_kv_geometry`):
        # what one block costs in device memory, at how many bits per KV
        # element
        self._bytes_per_block: Optional[int] = None
        self._kv_bits: int = 16

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def num_seqs(self) -> int:
        return len(self._tables)

    # ---- refcounted block primitives ----
    def _take_free(self) -> int:
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def incref(self, block: int) -> None:
        """Add one lease to an already-allocated physical block (the
        prefix tree pins published blocks this way)."""
        n = self._refs[block] + 1
        self._refs[block] = n
        if n == 2 and self._reclaimer is not None:
            self._note_ref(block, n)   # 1 -> 2: a cached block got pinned

    def release_block(self, block: int) -> None:
        """Drop one lease; the block returns to the free pool when the
        last lease goes (the prefix tree's eviction path)."""
        self._release(block)

    def _release(self, b: int) -> None:
        n = self._refs[b] - 1
        if n:
            self._refs[b] = n
            if n == 1 and self._reclaimer is not None:
                self._note_ref(b, n)   # 2 -> 1: maybe only the cache left
        else:
            del self._refs[b]
            self._free.append(b)

    def _note_ref(self, block: int, n: int) -> None:
        """Tell the reclaimer a block crossed the pinned/unpinned
        boundary, so `RadixPrefixCache.reclaimable()` stays O(1)."""
        try:
            self._reclaimer.note_ref(block, n)
        except Exception:
            monitor.inc("serving.prefix_cache.reclaimer_errors")

    def ref_count(self, block: int) -> int:
        """Current lease count of a physical block (0 = free)."""
        return self._refs.get(block, 0)

    def set_cow_hook(self, hook: Optional[Callable[[int, int], None]]):
        """`hook(src_block, dst_block)` copies device KV on COW."""
        self._cow_hook = hook

    def set_kv_geometry(self, bytes_per_block: int,
                        kv_bits: int = 16) -> None:
        """Register the device-side byte cost of one pool block (across
        K+V, all layers, including any scale planes) and the KV element
        width. Engines call this at construction
        (`inference/kv_quant.kv_bytes_per_block` owns the formula)."""
        self._bytes_per_block = int(bytes_per_block)
        self._kv_bits = int(kv_bits)

    @property
    def kv_bits(self) -> int:
        return self._kv_bits

    @property
    def bytes_per_block(self) -> Optional[int]:
        return self._bytes_per_block

    def set_reclaimer(self, reclaimer) -> None:
        """Register the cache-eviction authority: an object with
        `evict(n_blocks) -> int`, `reclaimable() -> int` and
        `note_ref(block, n)`. Asked under pool pressure BEFORE
        `KVCacheExhausted` is raised."""
        self._reclaimer = reclaimer

    def reclaimable_blocks(self) -> int:
        """Blocks held only by the cache tree — free-on-demand
        capacity."""
        if self._reclaimer is None:
            return 0
        try:
            return int(self._reclaimer.reclaimable())
        except Exception:
            monitor.inc("serving.prefix_cache.reclaimer_errors")
            return 0

    def _ensure_free(self, need: int) -> None:
        """Reclaim cached blocks until `need` are free, as far as the
        reclaimer can. Never raises: the caller re-checks and raises the
        typed exhaustion itself (a failing reclaimer is counted)."""
        if need > len(self._free) and self._reclaimer is not None:
            try:
                self._reclaimer.evict(need - len(self._free))
            except Exception:
                monitor.inc("serving.prefix_cache.reclaimer_errors")

    @staticmethod
    def _is_guard(seq_id) -> bool:
        """Guard sequences hold sacrificial padding blocks (the serving
        scheduler leases them under negative seq ids); they are capacity
        overhead, not load."""
        return isinstance(seq_id, int) and seq_id < 0

    def _guard_blocks(self) -> int:
        return sum(len(self._tables[sid]) for sid in self._guard_ids)

    def utilization(self) -> float:
        """Fraction of the usable pool currently held by real demand,
        over PHYSICAL blocks (a block shared by N leases is one block of
        pressure). Guard blocks are excluded from both sides of the
        ratio, and so are cache-held reclaimable blocks: the prefix tree
        surrenders them on demand."""
        guard = self._guard_blocks()
        used = self.num_blocks - len(self._free) - guard \
            - self.reclaimable_blocks()
        return max(0, used) / max(self.num_blocks - guard, 1)

    def fragmentation(self) -> Dict:
        """Fragmentation view of the pool: per-sequence leased-vs-used
        blocks and tokens (`per_seq`); token-level internal fragmentation
        (clamped at 0 under sharing); sharing (`leased_blocks` counts a
        shared physical block once, `lease_count` the per-lease sum,
        `shared_blocks` the blocks with > 1 lease); and the free list's
        largest contiguous run of block ids with `1 - largest_run /
        free`."""
        free = sorted(self._free)
        largest_run = run = 0
        prev = None
        for b in free:
            run = run + 1 if prev is not None and b == prev + 1 else 1
            largest_run = max(largest_run, run)
            prev = b
        per_seq = {}
        physical: set = set()
        lease_count = used = tokens = guard = 0
        for sid, table in self._tables.items():
            if self._is_guard(sid):
                guard += len(table)
                continue
            n_leased = len(table)
            n_used = min(n_leased, self.blocks_needed(self._lens[sid]))
            per_seq[sid] = {"leased_blocks": n_leased,
                            "used_blocks": n_used,
                            "tokens": self._lens[sid]}
            physical.update(table)
            lease_count += n_leased
            used += n_used
            tokens += self._lens[sid]
        leased = len(physical)
        capacity_tokens = leased * self.block_size
        bpb = self._bytes_per_block
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "kv_bits": self._kv_bits,
            "bytes_per_block": bpb,
            "pool_bytes": bpb * self.num_blocks if bpb else None,
            "leased_bytes": bpb * leased if bpb else None,
            "free_blocks": len(free),
            "guard_blocks": guard,
            "leased_blocks": leased,
            "lease_count": lease_count,
            "shared_blocks": sum(1 for n in self._refs.values() if n > 1),
            "reclaimable_blocks": self.reclaimable_blocks(),
            "cow_copies": self.cow_copies,
            "used_blocks": used,
            "tokens": tokens,
            "utilization": round(self.utilization(), 4),
            "internal_frag_ratio": round(max(
                0.0, 1.0 - tokens / capacity_tokens), 4) if capacity_tokens
            else 0.0,
            "largest_free_run": largest_run,
            "free_fragmentation_ratio": round(
                1.0 - largest_run / len(free), 4) if free else 0.0,
            "per_seq": per_seq,
        }

    def blocks_needed(self, num_tokens: int) -> int:
        return max(1, (num_tokens + self.block_size - 1) // self.block_size)

    def can_allocate(self, num_tokens: int) -> bool:
        return len(self._free) + self.reclaimable_blocks() \
            >= self.blocks_needed(num_tokens)

    def allocate(self, seq_id: int, num_tokens: int) -> List[int]:
        """Reserve blocks for a new sequence of `num_tokens` tokens.

        Raises `SequenceTooLong` (never fits) or `KVCacheExhausted`
        (fits once blocks are freed) — never asserts: the serving path
        turns both into admission-control decisions.
        """
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        faults.check("serve.cache")
        need = self.blocks_needed(num_tokens)
        if need > self.max_blocks_per_seq:
            raise SequenceTooLong(need, self.max_blocks_per_seq)
        self._ensure_free(need)
        if need > len(self._free):
            raise KVCacheExhausted(need, len(self._free), self.num_blocks)
        blocks = [self._take_free() for _ in range(need)]
        self._tables[seq_id] = blocks
        self._lens[seq_id] = num_tokens
        if self._is_guard(seq_id):
            self._guard_ids.add(seq_id)
        return blocks

    def adopt(self, seq_id: int, blocks: List[int],
              num_tokens: int) -> List[int]:
        """Create a sequence whose table STARTS with already-allocated
        (shared) physical blocks — the prefix-tree lease path. Each block
        gains one lease; `num_tokens` of KV in them are the sequence's
        context. The table grows past them through `append_tokens` (COW
        fires if the first append lands inside the last shared block)."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        if len(blocks) > self.max_blocks_per_seq:
            raise SequenceTooLong(len(blocks), self.max_blocks_per_seq)
        if num_tokens > len(blocks) * self.block_size:
            raise ValueError("adopt: num_tokens exceeds block capacity")
        faults.check("serve.cache")
        for b in blocks:
            self.incref(b)
        self._tables[seq_id] = list(blocks)
        self._lens[seq_id] = num_tokens
        return list(blocks)

    def append_token(self, seq_id: int) -> None:
        """Account one generated token; grows the table on a block
        boundary."""
        self.append_tokens(seq_id, 1)

    def append_tokens(self, seq_id: int, n: int) -> None:
        """Account `n` new tokens at once (a prefill chunk, or a pending
        token and its drafts), growing the block table across as many
        block boundaries as needed.

        Copy-on-write: when the first new token lands inside a block
        whose refcount is > 1 (a shared prefix leased from the radix
        tree, or a `trim` back into shared territory followed by a
        divergent append), that block is copied to a fresh private block
        first (`cow_hook` moves the device KV); the other leases keep
        the original bytes.

        All-or-nothing: on `SequenceTooLong`/`KVCacheExhausted` neither the
        length nor the table changes, so the caller can retry with a
        smaller `n` or preempt. Rollback of a successful append is
        `trim(seq_id, old_len)`."""
        if n < 0:
            raise ValueError(f"append_tokens: n must be >= 0, got {n}")
        faults.check("serve.cache")
        old_len = self._lens[seq_id]
        new_len = old_len + n
        table = self._tables[seq_id]
        need = self.blocks_needed(new_len) - len(table)
        # COW trigger: the FIRST new token's write target is an existing
        # table block that other leases share (a partial shared block, or
        # a full one a boundary-capped prefix hit kept)
        cow_idx = None
        if n > 0:
            idx = old_len // self.block_size
            if idx < len(table) and self._refs[table[idx]] > 1:
                cow_idx = idx
        extra = 1 if cow_idx is not None else 0
        if need > 0 and len(table) + need > self.max_blocks_per_seq:
            raise SequenceTooLong(len(table) + need,
                                  self.max_blocks_per_seq)
        if max(need, 0) + extra > len(self._free):
            self._ensure_free(max(need, 0) + extra)
        if max(need, 0) + extra > len(self._free):
            raise KVCacheExhausted(max(need, 0) + extra, len(self._free),
                                   self.num_blocks)
        if cow_idx is not None:
            self._cow(seq_id, cow_idx)
        for _ in range(max(need, 0)):
            table.append(self._take_free())
        self._lens[seq_id] = new_len

    def _cow(self, seq_id: int, idx: int) -> int:
        """Copy block `idx` of `seq_id`'s table into a fresh private
        block (the caller guarantees a free block exists). The hook runs
        BEFORE any bookkeeping changes, so a hook that raises leaves the
        pool's books exactly as they were (what the device did is the
        engine's to say: see `copy_kv_block`)."""
        table = self._tables[seq_id]
        src = table[idx]
        dst = self._free.pop()
        if self._cow_hook is not None:
            try:
                self._cow_hook(src, dst)
            except Exception:
                self._free.append(dst)
                raise
        self._refs[dst] = 1
        self._release(src)             # caller checked > 1: never frees
        table[idx] = dst
        self.cow_copies += 1
        monitor.inc("serving.prefix_cache.cow_copies")
        return dst

    def trim(self, seq_id: int, num_tokens: int) -> None:
        """Shrink a sequence to `num_tokens` tokens, returning surplus
        blocks to the pool (shared blocks just drop this sequence's
        lease). Trimming INTO a shared block is safe: the next divergent
        append copies it."""
        if num_tokens > self._lens[seq_id]:
            raise ValueError("trim can only shrink a sequence")
        keep = self.blocks_needed(num_tokens)
        table = self._tables[seq_id]
        while len(table) > keep:
            self._release(table.pop())
        self._lens[seq_id] = num_tokens

    def free(self, seq_id: int) -> None:
        for b in self._tables.pop(seq_id):
            self._release(b)
        self._lens.pop(seq_id)
        self._guard_ids.discard(seq_id)

    def seq_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def seq_blocks(self, seq_id: int) -> int:
        """Number of physical blocks currently leased by `seq_id` (0 for
        an unknown sequence)."""
        return len(self._tables.get(seq_id, ()))

    def blocks_of(self, seq_id: int) -> Tuple[int, ...]:
        """The physical block ids leased by `seq_id` in logical order
        (empty for an unknown sequence) — the prefix tree's publish input
        and the leak audit's."""
        return tuple(self._tables.get(seq_id, ()))

    def check_consistency(self, external: Optional[Dict[int, int]] = None):
        """Invariant audit: the free list unique and disjoint from live
        refs, every pool block accounted exactly once, every refcount
        positive and — when `external` maps block -> leases held by
        non-sequence owners (the prefix tree) — exactly equal to table
        appearances + external leases. Raises AssertionError naming the
        broken invariant."""
        free = self._free
        assert len(free) == len(set(free)), "duplicate free-list entry"
        assert not (set(free) & set(self._refs)), \
            "block both free and referenced"
        assert len(free) + len(self._refs) == self.num_blocks, \
            f"pool accounting broken: {len(free)} free + " \
            f"{len(self._refs)} live != {self.num_blocks}"
        assert all(n >= 1 for n in self._refs.values()), \
            "non-positive refcount"
        counts: Dict[int, int] = {}
        for table in self._tables.values():
            for b in table:
                counts[b] = counts.get(b, 0) + 1
        if external is not None:
            for b, n in external.items():
                counts[b] = counts.get(b, 0) + n
            assert counts == self._refs, \
                f"refcount mismatch: tables+external {counts} != " \
                f"refs {self._refs}"
        else:
            for b, n in counts.items():
                assert self._refs.get(b, 0) >= n, \
                    f"block {b}: {n} table leases > refcount " \
                    f"{self._refs.get(b, 0)}"

    def block_table_array(self, seq_ids, pad: int = 0) -> np.ndarray:
        """Dense [len(seq_ids), max_blocks_per_seq] int32 table.

        `pad` fills entries past each sequence's allocation (default 0)."""
        out = np.full((len(seq_ids), self.max_blocks_per_seq), pad, np.int32)
        for i, sid in enumerate(seq_ids):
            t = self._tables[sid]
            out[i, :len(t)] = t
        return out
