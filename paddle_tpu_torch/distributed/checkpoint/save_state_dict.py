"""Sharded checkpoint save: the port of
`paddle_tpu/distributed/checkpoint/save_state_dict.py`, in the same file
layout.

Each tensor of a state_dict is one shard at offset zero of the process's
own file (`{rank}_0.distcp`: the port's tensors are whole on their
device); the coordinator writes the global `0.metadata` index last. The
layout is the JAX package's: safetensors shards (JSON header, raw bytes,
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

from ...core.tensor import Tensor
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


def _host_copy(t) -> object:
    """A finished host copy of a Tensor, torch tensor or array."""
    d = t._data if isinstance(t, Tensor) else t
    if isinstance(d, torch.Tensor):
        d = d.detach()
        return d.cpu() if d.device.type != "cpu" else d.clone()
    return np.array(d, copy=True)


def snapshot_state_dict(state_dict: Dict[str, object]) -> _Snapshot:
    """Device-to-host snapshot of `state_dict`, on the caller's thread."""
    meta = Metadata(state_dict_metadata={}, storage_metadata={},
                    flat_mapping=None)
    rank = _rank()
    fname = f"{rank}_0.distcp"
    blobs: dict = {}
    for key, t in state_dict.items():
        host = _host_copy(t)
        offset = (0,) * host.ndim
        blobs[(key, offset)] = host
        meta.storage_metadata[LocalTensorIndex(key, offset)] = fname
        meta.state_dict_metadata[key] = [LocalTensorMetadata(
            offset, tuple(host.shape), sft.dtype_name(host),
            tuple(host.shape))]
    return _Snapshot(meta, {rank: blobs})


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
