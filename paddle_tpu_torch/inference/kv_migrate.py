"""KV-block migration: export and import one sequence's paged KV (the
port of `paddle_tpu/inference/kv_migrate.py`).

The unit of transfer is the paged pool's block: a source engine gathers
a sequence's committed blocks in one indexed copy per pool tensor, and a
target engine scatters them into blocks of its own pool. On an int8 pool
the K and V bytes and both per-slot scale planes travel in one payload,
so quantized state never parts from its scales. The same primitive backs
a session handoff between engines (`Scheduler.import_session`) and the
streaming of a radix-cached prefix between schedulers
(`Scheduler.export_prefix` / `import_prefix`).

Who owns what:

- Engines own the device work: `extract_kv_blocks(seq_id)` and
  `inject_kv_blocks(seq_id, payload)` on `LlamaInferenceEngine`,
  `MLPLMEngine` and `serving.lora.LoRAEngine`, through `extract_payload`
  / `inject_payload` below, over the pools and books they are given. The gather
  returns copies (the source pool lives on); the scatter writes the
  target pools in place and copies out of the payload, so one payload
  can be injected into several engines.
- This module owns the wire format: the versioned header and the check
  that runs before a target is touched.

A slab holds the sequence's real blocks only (``num_blocks`` rows on the
block axis), so a move reads and writes what the sequence holds and no
index repeats in a scatter. The header is the JAX package's field for
field (it carries ``max_blocks_per_seq`` and ``num_blocks`` as there);
the JAX package pads its slabs to ``max_blocks_per_seq`` rows for one
compiled shape (`pad_block_indices`), which eager PyTorch does not need.

Failures are typed and ordered: `check_header` raises `KVMigrationError`
naming the first mismatching field BEFORE the target's pool or block
manager is touched; capacity problems surface as the manager's own
`KVCacheExhausted` / `SequenceTooLong` from `allocate`; any failure after
allocation frees the just-allocated blocks before re-raising, so a
failed inject never leaks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

__all__ = ["PAYLOAD_VERSION", "KVMigrationError", "KVBlockPayload",
           "pad_block_indices", "check_header", "dtype_name",
           "extract_payload", "inject_payload"]

PAYLOAD_VERSION = 1


class KVMigrationError(ValueError):
    """A payload that cannot be injected into this engine (version,
    geometry, kv_bits or engine-family mismatch, or an engine without the
    primitive). Raised BEFORE any allocation or pool write on the target,
    so the caller can fall back (re-prefill) with the target untouched."""


class KVBlockPayload:
    """One sequence's migrated KV: a header (geometry and provenance) and
    the slabs gathered from the source pool.

    ``header`` carries the source engine's geometry (checked against the
    target by `check_header`) plus ``num_blocks`` (the slabs' length on
    their block axis) and ``num_tokens`` (committed KV length). ``slabs`` maps a plane name to a tensor on the source
    engine's device; it stays valid after an inject (the scatter copies
    out of it)."""

    __slots__ = ("header", "slabs")

    def __init__(self, header: Mapping[str, Any],
                 slabs: Mapping[str, Any]):
        self.header: Dict[str, Any] = dict(header)
        self.slabs: Dict[str, Any] = dict(slabs)

    @property
    def num_tokens(self) -> int:
        return int(self.header["num_tokens"])

    @property
    def num_blocks(self) -> int:
        return int(self.header["num_blocks"])

    @property
    def nbytes(self) -> int:
        """Payload bytes: the slabs' (every row a real block)."""
        return sum(int(s.numel() * s.element_size())
                   for s in self.slabs.values())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"KVBlockPayload(engine={self.header.get('engine')!r}, "
                f"tokens={self.header.get('num_tokens')}, "
                f"blocks={self.header.get('num_blocks')}, "
                f"kv_bits={self.header.get('kv_bits')})")


def pad_block_indices(blocks: Sequence[int], max_blocks: int) -> np.ndarray:
    """``[n]`` real block ids -> ``[max_blocks]`` int32, padded by
    repeating the last real id: the JAX package's fixed-length index
    form, for a consumer that wants one shape whatever the length. The
    port's own slabs are not padded."""
    n = len(blocks)
    if n == 0 or n > max_blocks:
        raise KVMigrationError(
            f"cannot pad {n} block indices into max_blocks_per_seq="
            f"{max_blocks}")
    idx = np.empty((max_blocks,), np.int32)
    idx[:n] = np.asarray(blocks, np.int32)
    idx[n:] = idx[n - 1]
    return idx


def check_header(header: Mapping[str, Any],
                 expected: Mapping[str, Any]) -> None:
    """Check an incoming payload header against the target engine's own
    geometry header: every key the target declares must match, in sorted
    key order. Raises `KVMigrationError` naming the first mismatching
    field."""
    if not isinstance(header, Mapping):
        raise KVMigrationError(
            f"payload header must be a mapping, got "
            f"{type(header).__name__}")
    for key in sorted(expected):
        if key not in header:
            raise KVMigrationError(
                f"payload header missing field {key!r} "
                f"(target expects {expected[key]!r})")
        if header[key] != expected[key]:
            raise KVMigrationError(
                f"payload header mismatch on {key!r}: payload has "
                f"{header[key]!r}, target engine expects "
                f"{expected[key]!r}")


def dtype_name(dtype: torch.dtype) -> str:
    """A pool dtype under the name the JAX package writes into its
    headers (``"bfloat16"``, ``"float32"``, ``"int8"``), so headers of
    the two packages agree field for field."""
    return str(dtype).replace("torch.", "")


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64)).to(device)


def _gather_blocks(pools: Sequence[torch.Tensor], idx,
                  axis: int) -> List[torch.Tensor]:
    """Copies of each pool's blocks `idx` along its block `axis`
    (`index_select`: new tensors, the pools untouched)."""
    i = _index(idx, pools[0].device)
    return [p.index_select(axis, i) for p in pools]


def _scatter_blocks(pools: Sequence[torch.Tensor], idx,
                   slabs: Sequence[torch.Tensor], axis: int) -> None:
    """Write `slabs` into each pool's blocks `idx` along its block `axis`,
    in place (`index_copy_`, which copies: the slabs stay the caller's).
    Every slab is checked against its pool (dtype and shape) before the
    first write."""
    i = _index(idx, pools[0].device)
    for p, s in zip(pools, slabs):
        want = list(p.shape)
        want[axis] = i.shape[0]
        if s.dtype != p.dtype or list(s.shape) != want:
            raise KVMigrationError(
                f"payload slab {s.dtype} {tuple(s.shape)} does not fit a "
                f"{p.dtype} pool of {tuple(p.shape)} (block axis {axis}, "
                f"{i.shape[0]} indices)")
    for p, s in zip(pools, slabs):
        p.index_copy_(axis, i, s.to(p.device))


def extract_payload(manager, header: Mapping[str, Any],
                    pools: Sequence[torch.Tensor], names: Sequence[str],
                    axis: int, seq_id: int) -> KVBlockPayload:
    """An engine's `extract_kv_blocks` over `pools` (its own, or a
    wrapper's) and `manager`'s books: `seq_id`'s blocks gathered from
    each pool along `axis` into the slab of the same position in `names`;
    `header` gains `num_blocks` and `num_tokens`."""
    blocks = manager.blocks_of(seq_id)
    if not blocks:
        raise KVMigrationError(
            f"sequence {seq_id} holds no KV blocks on this engine")
    header = dict(header, num_blocks=len(blocks),
                  num_tokens=manager.seq_len(seq_id))
    with torch.no_grad():
        slabs = _gather_blocks(pools, blocks, axis)
    return KVBlockPayload(header, dict(zip(names, slabs)))


def inject_payload(manager, header: Mapping[str, Any],
                   pools: Sequence[torch.Tensor], names: Sequence[str],
                   axis: int, seq_id: int, payload: KVBlockPayload) -> None:
    """An engine's `inject_kv_blocks`: check the header against `header`
    (before anything is touched), allocate `payload.num_tokens` under
    `seq_id` in `manager`, scatter the slabs into `pools` along `axis`;
    any failure after the allocation frees it and re-raises."""
    check_header(payload.header, header)
    blocks = manager.allocate(seq_id, payload.num_tokens)
    try:
        if len(blocks) != payload.num_blocks:
            raise KVMigrationError(
                f"payload carries {payload.num_blocks} blocks but "
                f"{payload.num_tokens} tokens allocate {len(blocks)} here")
        names = list(names)[:len(pools)]
        missing = [n for n in names if n not in payload.slabs]
        if missing:
            raise KVMigrationError(f"payload lacks the planes {missing}")
        with torch.no_grad():
            _scatter_blocks(pools, blocks,
                            [payload.slabs[n] for n in names], axis)
    except Exception:
        manager.free(seq_id)
        raise
