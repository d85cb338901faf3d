"""Sharded checkpoint load with reshard-on-load: the port of
`paddle_tpu/distributed/checkpoint/load_state_dict.py`.

The destination's tensors carry their target placements at load time,
which may differ from the saved ones (a dp2 x mp4 checkpoint loads onto
dp4 x mp2, a world-8 one onto world 3 or 2). For each rank's shard of a
DistTensor destination (replicated copies once) the loader takes the
overlap of every saved shard of the same tensor (the reference's
read-items plan) and copies just those bytes into that shard, a view of
the destination's global tensor, in place. A destination without
placements (a plain Tensor, torch tensor or numpy array) is assembled
whole. A parameter keeps its identity (the optimizer's state is keyed on
it); every value is cast to the destination's dtype and device.

Every failure of a torn or rotted directory (no `0.metadata`, a missing
or short shard file, a missing header entry, a crc mismatch) raises the
typed `CheckpointCorrupt`, naming the tensor and file.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

from ...core import lazy
from ...core.tensor import Tensor
from ..auto_parallel import sharding_bridge as sb
from ...framework import dtype as dtype_mod
from ...framework import safetensors as sft
from .errors import CheckpointCorrupt
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata
from .save_state_dict import _wait_pending, shard_name

__all__ = ["load_state_dict", "verify_checkpoint"]


class _StorageReader:
    """Per-shard reads of the `.distcp` files: each header parsed once,
    each tensor read by seek and crc-verified."""

    def __init__(self, path: str):
        self.path = path
        self._readers: Dict[str, sft.SafetensorsReader] = {}

    def _reader(self, fname: str, key: str = "") -> sft.SafetensorsReader:
        r = self._readers.get(fname)
        if r is None:
            try:
                r = sft.SafetensorsReader(os.path.join(self.path, fname))
            except FileNotFoundError:
                raise CheckpointCorrupt(
                    self.path, "shard file referenced by 0.metadata is "
                    "missing", key=key, file=fname)
            except (ValueError, KeyError, EOFError, OSError,
                    struct.error) as exc:
                raise CheckpointCorrupt(
                    self.path, f"unreadable shard header: {exc!r}",
                    key=key, file=fname)
            self._readers[fname] = r
        return r

    def blob(self, fname: str, key, offset) -> torch.Tensor:
        r = self._reader(fname, key=key)
        name = shard_name(key, offset)
        if name not in r.header:
            raise CheckpointCorrupt(
                self.path, "shard entry missing from file header",
                key=key, file=fname)
        try:
            return r.get_torch(name)       # crc32-verified read
        except (IOError, ValueError, KeyError, RuntimeError) as exc:
            raise CheckpointCorrupt(
                self.path, f"shard read failed integrity check: {exc!r}",
                key=key, file=fname)


def _read_metadata(path: str) -> Metadata:
    """Parse the JSON `0.metadata` index."""
    try:
        with open(os.path.join(path, "0.metadata")) as f:
            raw = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorrupt(path, "no 0.metadata index (incomplete or "
                                "torn save)", file="0.metadata")
    except ValueError as exc:       # bad JSON or bytes that are not text
        raise CheckpointCorrupt(path, f"unparseable 0.metadata: {exc}",
                                file="0.metadata")
    meta = Metadata(state_dict_metadata={}, storage_metadata={},
                    flat_mapping=None)
    for key, metas in raw["state_dict_metadata"].items():
        meta.state_dict_metadata[key] = [
            LocalTensorMetadata(tuple(m["global_offset"]),
                                tuple(m["local_shape"]), m["dtype"],
                                tuple(m["global_shape"])) for m in metas]
    for name, fname in raw["storage_metadata"].items():
        key, _, off = name.rpartition("@@")
        offset = tuple(int(o) for o in off.split("_")) if off else ()
        meta.storage_metadata[LocalTensorIndex(key, offset)] = fname
    return meta


def _assemble(lo, shape, saved_metas, storage, reader, key, dtype,
              cache=None):
    """The block of `shape` at global offset `lo`, filled from the
    overlapping saved shards (`cache` keeps this key's shards read)."""
    out = torch.zeros(tuple(shape), dtype=dtype)
    hi = [a + s for a, s in zip(lo, shape)]
    for m in saved_metas:
        s_lo = list(m.global_offset)
        s_hi = [o + s for o, s in zip(m.global_offset, m.local_shape)]
        ilo = [max(a, b) for a, b in zip(lo, s_lo)]
        ihi = [min(a, b) for a, b in zip(hi, s_hi)]
        if any(a >= b for a, b in zip(ilo, ihi)):
            continue
        off = tuple(m.global_offset)
        src = None if cache is None else cache.get(off)
        if src is None:
            fname = storage[LocalTensorIndex(key, off)]
            src = reader.blob(fname, key, m.global_offset)
            if cache is not None:
                cache[off] = src
        src_sl = tuple(slice(a - o, b - o)
                       for a, b, o in zip(ilo, ihi, s_lo))
        dst_sl = tuple(slice(a - o, b - o) for a, b, o in zip(ilo, ihi, lo))
        # rank-normalise (0-d shards once stored as (1,))
        out[dst_sl] = src[src_sl].reshape(out[dst_sl].shape)
    return out


def verify_checkpoint(path: str, meta: Metadata = None,
                      reader: "_StorageReader" = None) -> Metadata:
    """Structural check of a checkpoint directory: the index parses, and
    every shard file it names exists and holds every shard assigned to
    it. Raises `CheckpointCorrupt` naming the first bad key / file;
    returns the metadata. Bytes are crc-checked on every read."""
    if meta is None:
        meta = _read_metadata(path)
    for key, metas in meta.state_dict_metadata.items():
        for m in metas:
            ix = LocalTensorIndex(key, tuple(m.global_offset))
            if ix not in meta.storage_metadata:
                raise CheckpointCorrupt(
                    path, "no shard file recorded for tensor shard "
                    f"(offset {tuple(m.global_offset)})", key=key,
                    file="0.metadata")
    if reader is None:
        reader = _StorageReader(path)
    by_file: Dict[str, list] = {}
    for ix, fname in meta.storage_metadata.items():
        by_file.setdefault(fname, []).append(ix)
    for fname, indices in sorted(by_file.items()):
        r = reader._reader(fname, key=indices[0].tensor_key)
        size = os.path.getsize(os.path.join(path, fname))
        for ix in indices:
            ent = r.header.get(shard_name(ix.tensor_key, ix.global_offset))
            if ent is None:
                raise CheckpointCorrupt(
                    path, "shard entry missing from file header",
                    key=ix.tensor_key, file=fname)
            if r._data_start + ent["data_offsets"][1] > size:
                raise CheckpointCorrupt(
                    path, f"shard file truncated ({size} bytes, tensor "
                    f"needs {r._data_start + ent['data_offsets'][1]})",
                    key=ix.tensor_key, file=fname)
    return meta


def load_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    offload: bool = False) -> None:
    """Load `path` into `state_dict` in place: a Tensor's or torch
    tensor's storage is overwritten (cast to its dtype, on its device); a
    numpy array entry is replaced by the loaded array."""
    _wait_pending(path)
    reader = _StorageReader(path)
    meta = verify_checkpoint(path, reader=reader)
    for key, t in state_dict.items():
        if key not in meta.state_dict_metadata:
            raise KeyError(f"checkpoint at {path} has no tensor '{key}'")
        saved = meta.state_dict_metadata[key]
        dtype = dtype_mod.convert_dtype(saved[0].dtype).torch_dtype
        dest = lazy.materialize(t) if isinstance(t, Tensor) else t
        if isinstance(dest, torch.Tensor):
            # each distinct shard of the destination (a plain tensor is
            # one shard at offset 0), from the saved ones
            cache: dict = {}
            seen = set()
            with torch.no_grad():
                for _rank, off, view in sb.local_shards(dest, sb.meta_of(t)):
                    if off in seen:
                        continue
                    seen.add(off)
                    view.copy_(_assemble(off, tuple(view.shape), saved,
                                         meta.storage_metadata, reader, key,
                                         dtype, cache))
            continue
        shape = tuple(int(s) for s in dest.shape)
        full = _assemble((0,) * len(shape), shape, saved,
                         meta.storage_metadata, reader, key, dtype)
        state_dict[key] = full.numpy() if full.dtype not in (
            torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2) else full
