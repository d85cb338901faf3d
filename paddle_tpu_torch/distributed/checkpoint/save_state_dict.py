"""Sharded checkpoint save: the port of
`paddle_tpu/distributed/checkpoint/save_state_dict.py`, in the same file
layout.

A DistTensor (a Tensor or torch tensor carrying a `DistMeta`,
`auto_parallel/sharding_bridge.py`) is saved shard by shard, each
rank's shard into that rank's file (`{rank}_0.distcp`), replicated
copies once: shards are deduplicated by `(key, global_offset)`, as the
JAX package does with its devices' shards. A tensor without placements
is one shard at offset zero of the process's own file. The coordinator
writes the global `0.metadata` index last. The layout is the JAX
package's: safetensors shards (JSON header, raw bytes,
a crc32 per tensor, written atomically by rename,
`framework/safetensors.py`) and a JSON index, no pickle; a checkpoint
either package writes loads in the other.

`snapshot_state_dict` copies every tensor to host memory on the caller's
thread, and that copy is finished when it returns: the optimizers write
parameters and moments in place, so a writer thread must never read live
device storage. `save_state_dict(async_save=True)` then writes on a
background thread whose failure re-raises as `AsyncSaveError` at the
next save to the same path, a wait, or a load of it.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ...core import lazy
from ...core.tensor import Tensor
from ..auto_parallel import sharding_bridge as sb
from ...framework import safetensors as sft
from .errors import AsyncSaveError
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata

__all__ = ["save_state_dict", "snapshot_state_dict", "write_snapshot",
           "shard_name"]

# the writer's tag in each file's metadata (the JAX package writes its
# own); neither package's loader reads it
FORMAT_TAG = "paddle_tpu_torch.distcp.v2+safetensors"


def shard_name(key: str, offset) -> str:
    """Flat tensor name inside a shard file: `<key>@@<o0>_<o1>...`."""
    return f"{key}@@{'_'.join(str(int(o)) for o in offset)}"


def _rank() -> int:
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


# one pending background write per destination path
_pending_lock = threading.Lock()
_pending_saves: Dict[str, threading.Thread] = {}


class _SaveThread(threading.Thread):
    """A background writer that keeps its exception instead of printing
    it and dying."""

    def __init__(self, write):
        super().__init__(daemon=False)
        self._write = write
        self.error: Optional[BaseException] = None

    def run(self):
        try:
            self._write()
        except BaseException as exc:  # surfaced by _wait_pending
            self.error = exc


def _wait_pending(path: Optional[str] = None):
    """Join pending async saves (all, or `path`'s) and re-raise the first
    captured failure as `AsyncSaveError` on this thread."""
    with _pending_lock:
        if path is None:
            items = list(_pending_saves.items())
            _pending_saves.clear()
        else:
            key = os.path.abspath(path)
            t = _pending_saves.pop(key, None)
            items = [(key, t)] if t is not None else []
    error = None
    for key, t in items:
        t.join()
        exc = getattr(t, "error", None)
        if exc is not None and error is None:
            error = AsyncSaveError(key, exc)
    if error is not None:
        raise error


class _Snapshot:
    """Host image of a state_dict: the shard metadata and every shard as
    a host tensor. Writing it is file I/O only, safe on any thread and
    safe to retry."""

    def __init__(self, meta: Metadata, per_device: Dict[int, dict]):
        self.meta = meta
        self.per_device = per_device


def _host_copy(d) -> object:
    """A finished, contiguous host copy of a torch tensor or array."""
    if isinstance(d, torch.Tensor):
        d = d.detach()
        return d.contiguous().cpu() if d.device.type != "cpu" \
            else d.clone(memory_format=torch.contiguous_format)
    return np.array(d, copy=True)


def _shards_of(t, rank: int):
    """`[(rank, global_offset, torch tensor or array)]`: a DistTensor's
    shards in rank order, else the whole value as `rank`'s one shard."""
    placed = sb.meta_of(t)
    if placed is not None:
        return sb.local_shards(t, placed)
    d = lazy.materialize(t) if isinstance(t, Tensor) else t
    ndim = d.dim() if isinstance(d, torch.Tensor) else np.ndim(d)
    return [(rank, (0,) * ndim, d)]


def snapshot_state_dict(state_dict: Dict[str, object]) -> _Snapshot:
    """Device-to-host snapshot of `state_dict`, on the caller's thread:
    every distinct shard copied to host memory."""
    meta = Metadata(state_dict_metadata={}, storage_metadata={},
                    flat_mapping=None)
    me = _rank()
    per_device: Dict[int, dict] = {}
    for key, t in state_dict.items():
        d = lazy.materialize(t) if isinstance(t, Tensor) else t
        global_shape = tuple(int(s) for s in np.shape(d)) \
            if not isinstance(d, torch.Tensor) else tuple(d.shape)
        metas, seen = [], set()
        for rank, offset, data in _shards_of(t, me):
            if offset in seen:       # a replicated shard: saved once
                continue
            seen.add(offset)
            host = _host_copy(data)
            fname = f"{rank}_0.distcp"
            per_device.setdefault(rank, {})[(key, offset)] = host
            meta.storage_metadata[LocalTensorIndex(key, offset)] = fname
            metas.append(LocalTensorMetadata(
                offset, tuple(host.shape), sft.dtype_name(host),
                global_shape))
        meta.state_dict_metadata[key] = metas
    return _Snapshot(meta, per_device)


def write_snapshot(snap: _Snapshot, path: str,
                   coordinator_rank: int = 0) -> None:
    """Write a host snapshot: the shard files, then (on the coordinator)
    the `0.metadata` index last, whose presence marks a complete
    checkpoint."""
    os.makedirs(path, exist_ok=True)
    for dev_id, blobs in snap.per_device.items():
        tensors = {shard_name(k, off): host
                   for (k, off), host in blobs.items()}
        sft.save_file(tensors, os.path.join(path, f"{dev_id}_0.distcp"),
                      metadata={"format": FORMAT_TAG})
    if _rank() == coordinator_rank:
        index = {
            "format": FORMAT_TAG,
            "state_dict_metadata": {
                k: [{"global_offset": list(m.global_offset),
                     "local_shape": list(m.local_shape),
                     "dtype": m.dtype,
                     "global_shape": list(m.global_shape)}
                    for m in metas]
                for k, metas in snap.meta.state_dict_metadata.items()},
            "storage_metadata": {
                shard_name(ix.tensor_key, ix.global_offset): fname
                for ix, fname in snap.meta.storage_metadata.items()},
        }
        tmp = os.path.join(path, "0.metadata.tmp")
        with open(tmp, "w") as f:
            json.dump(index, f)
        os.replace(tmp, os.path.join(path, "0.metadata"))


def save_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False) -> None:
    """Save `state_dict` to `path` as `{rank}_0.distcp` shard files and a
    global `0.metadata` index. A save to a path with a pending write
    waits for it first (and raises its failure)."""
    os.makedirs(path, exist_ok=True)
    snap = snapshot_state_dict(state_dict)

    def write():
        write_snapshot(snap, path, coordinator_rank)

    key = os.path.abspath(path)
    th = _SaveThread(write)
    while True:
        with _pending_lock:
            prev = _pending_saves.get(key)
            if prev is None:
                _pending_saves[key] = th
                th.start()
                break
        prev.join()
        with _pending_lock:
            if _pending_saves.get(key) is prev:
                _pending_saves.pop(key)
        if prev.error is not None:
            raise AsyncSaveError(key, prev.error)
    if not async_save:
        th.join()
        with _pending_lock:
            if _pending_saves.get(key) is th:
                _pending_saves.pop(key)
        if th.error is not None:
            raise th.error  # sync callers get the original exception
