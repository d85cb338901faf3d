"""Paged KV-cache block management (host side).

A copy of the part of `paddle_tpu/inference/cache.py`'s
`BlockCacheManager` that the ragged serving path uses. Device memory is a
pool of fixed-size blocks; each sequence holds a block table mapping
logical block index -> physical block id. Allocation and free are O(1)
host bookkeeping, so the device pool never reallocates.

Exhaustion is a scheduling event, not a crash: `allocate` and
`append_tokens` raise the typed `KVCacheExhausted` (pool empty) or
`SequenceTooLong` (per-sequence block cap), which the serving scheduler
consumes to queue or preempt requests.

Left out until the prefix-cache slice: shared (reference-counted) blocks,
copy-on-write and the cache reclaimer. Unlike the JAX package's module,
this one looks nothing up in `sys.modules` and arms no fault-injection
site.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

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
        self._guard_ids: set = set()   # guard seqs, so utilization() is
        #                                O(#guards) on the step path
        # KV byte geometry (engines register it via `set_kv_geometry`):
        # what one block costs in device memory, at how many bits per KV
        # element
        self._bytes_per_block: Optional[int] = None
        self._kv_bits: int = 16

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def set_kv_geometry(self, bytes_per_block: int,
                        kv_bits: int = 16) -> None:
        """Register the device-side byte cost of one pool block (across
        K+V and all layers) and the KV element width. Engines call this
        at construction (`inference/kv_quant.kv_bytes_per_block` owns the
        formula)."""
        self._bytes_per_block = int(bytes_per_block)
        self._kv_bits = int(kv_bits)

    @property
    def kv_bits(self) -> int:
        return self._kv_bits

    @property
    def bytes_per_block(self) -> Optional[int]:
        return self._bytes_per_block

    @staticmethod
    def _is_guard(seq_id) -> bool:
        """Guard sequences hold sacrificial padding blocks (the serving
        scheduler leases them under negative seq ids); they are capacity
        overhead, not load."""
        return isinstance(seq_id, int) and seq_id < 0

    def utilization(self) -> float:
        """Fraction of the usable pool currently held by real demand.
        Guard blocks are excluded from both sides of the ratio: leased
        forever, they are a permanent floor, not load."""
        guard = sum(len(self._tables[sid]) for sid in self._guard_ids)
        used = self.num_blocks - len(self._free) - guard
        return max(0, used) / max(self.num_blocks - guard, 1)

    def blocks_needed(self, num_tokens: int) -> int:
        return max(1, (num_tokens + self.block_size - 1) // self.block_size)

    def allocate(self, seq_id: int, num_tokens: int) -> List[int]:
        """Reserve blocks for a new sequence of `num_tokens` tokens.

        Raises `SequenceTooLong` (never fits) or `KVCacheExhausted`
        (fits once blocks are freed) — never asserts: the serving path
        turns both into admission-control decisions.
        """
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        need = self.blocks_needed(num_tokens)
        if need > self.max_blocks_per_seq:
            raise SequenceTooLong(need, self.max_blocks_per_seq)
        if need > len(self._free):
            raise KVCacheExhausted(need, len(self._free), self.num_blocks)
        blocks = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = blocks
        self._lens[seq_id] = num_tokens
        if self._is_guard(seq_id):
            self._guard_ids.add(seq_id)
        return blocks

    def append_token(self, seq_id: int) -> None:
        """Account one generated token; grows the table on a block
        boundary."""
        self.append_tokens(seq_id, 1)

    def append_tokens(self, seq_id: int, n: int) -> None:
        """Account `n` new tokens at once (a prefill chunk, or a pending
        token and its drafts), growing the block table across as many block boundaries
        as needed.

        All-or-nothing: on `SequenceTooLong`/`KVCacheExhausted` neither the
        length nor the table changes, so the caller can retry with a
        smaller `n` or preempt. Rollback of a successful append is
        `trim(seq_id, old_len)`."""
        if n < 0:
            raise ValueError(f"append_tokens: n must be >= 0, got {n}")
        new_len = self._lens[seq_id] + n
        table = self._tables[seq_id]
        need = self.blocks_needed(new_len) - len(table)
        if need > 0 and len(table) + need > self.max_blocks_per_seq:
            raise SequenceTooLong(len(table) + need,
                                  self.max_blocks_per_seq)
        if need > len(self._free):
            raise KVCacheExhausted(need, len(self._free), self.num_blocks)
        for _ in range(max(need, 0)):
            table.append(self._free.pop())
        self._lens[seq_id] = new_len

    def trim(self, seq_id: int, num_tokens: int) -> None:
        """Shrink a sequence to `num_tokens` tokens, returning surplus
        blocks to the pool."""
        if num_tokens > self._lens[seq_id]:
            raise ValueError("trim can only shrink a sequence")
        keep = self.blocks_needed(num_tokens)
        table = self._tables[seq_id]
        while len(table) > keep:
            self._free.append(table.pop())
        self._lens[seq_id] = num_tokens

    def free(self, seq_id: int) -> None:
        self._free.extend(self._tables.pop(seq_id))
        self._lens.pop(seq_id)
        self._guard_ids.discard(seq_id)

    def seq_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def seq_blocks(self, seq_id: int) -> int:
        """Number of physical blocks currently leased by `seq_id` (0 for
        an unknown sequence)."""
        return len(self._tables.get(seq_id, ()))

    def block_table_array(self, seq_ids, pad: int = 0) -> np.ndarray:
        """Dense [len(seq_ids), max_blocks_per_seq] int32 table.

        `pad` fills entries past each sequence's allocation (default 0)."""
        out = np.full((len(seq_ids), self.max_blocks_per_seq), pad, np.int32)
        for i, sid in enumerate(seq_ids):
            t = self._tables[sid]
            out[i, :len(t)] = t
        return out
