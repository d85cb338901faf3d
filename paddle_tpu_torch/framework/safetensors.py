"""Safetensors-format tensor serialization, the port of
`paddle_tpu/framework/safetensors.py` with the same byte layout (reference
analog:
`python/paddle/framework/io_utils.py` raw-tensor protocol; format spec is
the public safetensors layout: 8-byte LE header length, JSON header with
per-tensor dtype/shape/data_offsets, then a flat byte buffer).

Used by the distributed checkpoint layer instead of pickle blobs: headers
are JSON (no arbitrary code execution on load), reads are lazy per tensor
(offset seeks, no full-file materialization), and integrity is covered by
a crc32 per tensor stored under `__metadata__`.

Host torch tensors are written and read as well (`save_file` takes them
beside numpy arrays, `SafetensorsReader.get_torch` returns one), by their
bytes: a bfloat16 or float8 tensor needs no `ml_dtypes`.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["save_file", "load_file", "SafetensorsReader", "np_dtype",
           "dtype_name"]

_DTYPE_TO_TAG = {
    "float64": "F64", "float32": "F32", "float16": "F16",
    "bfloat16": "BF16", "int64": "I64", "int32": "I32", "int16": "I16",
    "int8": "I8", "uint8": "U8", "bool": "BOOL", "uint16": "U16",
    "uint32": "U32", "uint64": "U64", "float8_e4m3fn": "F8_E4M3",
    "float8_e5m2": "F8_E5M2", "complex64": "C64", "complex128": "C128",
}
_TAG_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TAG.items()}


def np_dtype(name: str) -> np.dtype:
    """Resolve a dtype NAME (incl. numpy-extension float types, which
    need `ml_dtypes`) to np.dtype via the framework's dtype registry."""
    from . import dtype as dtype_mod

    d = dtype_mod.convert_dtype(name).np_dtype
    if d is None:
        raise TypeError(f"numpy has no {name} without ml_dtypes")
    return np.dtype(d)


def dtype_name(a) -> str:
    """The numpy-style name of a numpy array's or torch tensor's dtype."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return np.dtype(a.dtype).name


def _byte_view(a) -> np.ndarray:
    """A uint8 view of a host array's bytes (extension dtypes export no
    buffer; a torch tensor is viewed, not converted)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy() if t.numel() else \
            np.zeros(0, np.uint8)
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


def save_file(tensors: Dict[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (numpy arrays or host torch tensors) in
    safetensors layout. A crc32 per tensor is added to `__metadata__`
    (key `crc32:<name>`) for load-time verification."""
    header: Dict[str, object] = {}
    meta = dict(metadata or {})
    offset = 0
    arrays = []
    for name in sorted(tensors):
        a = tensors[name]
        tag = _DTYPE_TO_TAG.get(dtype_name(a))
        if tag is None:
            raise ValueError(f"unsupported dtype {a.dtype} for '{name}'")
        view = _byte_view(a)
        header[name] = {"dtype": tag, "shape": list(a.shape),
                        "data_offsets": [offset, offset + view.nbytes]}
        meta[f"crc32:{name}"] = str(zlib.crc32(view))
        offset += view.nbytes
        arrays.append(view)
    if meta:
        header["__metadata__"] = meta
    hbytes = json.dumps(header, sort_keys=True).encode()
    pad = (8 - len(hbytes) % 8) % 8  # spec: align the buffer section
    hbytes += b" " * pad
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hbytes)))
        f.write(hbytes)
        for view in arrays:  # streamed: peak memory stays ~one checkpoint
            f.write(view)
    os.replace(tmp, path)  # atomic: readers never see a torn file


class SafetensorsReader:
    """Lazy reader: parses the header once, reads tensors by offset seek.
    `verify=True` checks the stored crc32 on every read."""

    def __init__(self, path: str, verify: bool = True):
        self.path = path
        self.verify = verify
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            self.header = json.loads(f.read(hlen))
        self._data_start = 8 + hlen
        self.metadata = self.header.pop("__metadata__", {})

    def keys(self):
        return list(self.header)

    def _raw(self, name: str) -> bytes:
        ent = self.header[name]
        start, end = ent["data_offsets"]
        with open(self.path, "rb") as f:
            f.seek(self._data_start + start)
            raw = f.read(end - start)
        if len(raw) != end - start:
            raise IOError(f"tensor '{name}' in {self.path} is truncated")
        if self.verify:
            want = self.metadata.get(f"crc32:{name}")
            if want is not None and int(want) != zlib.crc32(raw):
                raise IOError(
                    f"checksum mismatch for tensor '{name}' in {self.path} "
                    "— the checkpoint file is corrupt or truncated")
        return raw

    def get_tensor(self, name: str) -> np.ndarray:
        raw = self._raw(name)
        ent = self.header[name]
        dt = np_dtype(_TAG_TO_DTYPE[ent["dtype"]])
        return np.frombuffer(raw, dtype=dt).reshape(ent["shape"])

    def get_torch(self, name: str) -> torch.Tensor:
        """The tensor as a host torch tensor (a new buffer)."""
        from . import dtype as dtype_mod

        raw = self._raw(name)
        ent = self.header[name]
        dt = dtype_mod.convert_dtype(_TAG_TO_DTYPE[ent["dtype"]]).torch_dtype
        b = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw \
            else torch.zeros(0, dtype=torch.uint8)
        return b.view(dt).reshape(ent["shape"])


def load_file(path: str, verify: bool = True) -> Dict[str, np.ndarray]:
    r = SafetensorsReader(path, verify=verify)
    return {k: r.get_tensor(k) for k in r.keys()}
