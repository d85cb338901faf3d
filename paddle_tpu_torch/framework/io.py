"""`paddle.save` / `paddle.load`: the port of `paddle_tpu/framework/io.py`.

A file is a pickle of the object with each Tensor replaced by a
`_TensorPayload`: the array (a numpy array, or for bfloat16 and the
float8 types its raw bytes as uint8 with `raw`, `shape` and the dtype
tag), `stop_gradient` and `name`. The payload class is pickled under the
JAX package's global, `paddle_tpu.framework.io._TensorPayload`, so a file
written by either package loads in the other with the same bits
(`.pdparams`, `.pdopt`, `.pdiparams`, nested containers):
- writing names that global without importing it (`_Pickler` writes the
  module and class names itself, where pickle would import the module to
  check them);
- reading maps it onto the port's own class (`_Unpickler.find_class`),
  and refuses any other global of the JAX package or of jax, so loading
  never imports either.
bfloat16 and float8 tensors go through their bytes, so neither side
needs `ml_dtypes`. Loaded tensors go to the expected place (the card
unless `set_device("cpu")`); `return_numpy=True` gives numpy arrays.
"""
from __future__ import annotations

import io
import os
import pickle
import re
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_PROTO = 4
# the global the JAX package pickles its payload class under
_PAYLOAD_MODULE = "paddle_tpu.framework.io"
_PAYLOAD_NAME = "_TensorPayload"
_RAW = {torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2}
# the JAX package and jax: no other global of theirs is loaded
_REFUSED = re.compile(r"^(jax|jaxlib|paddle_tpu)(\.|$)")


class _TensorPayload:
    """Pickle stand-in for a Tensor (the JAX package's class of the same
    name, attribute for attribute)."""

    def __init__(self, array: np.ndarray, dtype_name: str,
                 stop_gradient=True, name=None):
        self.array = array
        self.dtype_name = dtype_name
        self.stop_gradient = stop_gradient
        self.name = name


class _Pickler(pickle._Pickler):
    """pickle's Python pickler, writing `_TensorPayload` as the JAX
    package's global without importing that package."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_PAYLOAD_MODULE)
            self.save(_PAYLOAD_NAME)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_PAYLOAD_MODULE}\n"
                       f"{_PAYLOAD_NAME}\n".encode())
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == (_PAYLOAD_MODULE, _PAYLOAD_NAME):
            return _TensorPayload
        if _REFUSED.match(module):
            raise pickle.UnpicklingError(
                f"paddle.load: {module}.{name} is not a paddle file's "
                f"tensor payload; the port does not import "
                f"{module.split('.')[0]}")
        return super().find_class(module, name)


def _pack(obj):
    from ..core.tensor import Tensor

    if isinstance(obj, Tensor):
        d = obj._data.detach().cpu()
        if d.dtype in _RAW:
            p = _TensorPayload(
                d.contiguous().reshape(-1).view(torch.uint8).numpy().copy(),
                obj.dtype.name, obj.stop_gradient, obj.name)
            p.shape = tuple(d.shape)
            p.raw = True
            return p
        p = _TensorPayload(d.numpy().copy(), obj.dtype.name,
                           obj.stop_gradient, obj.name)
        p.raw = False
        return p
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _payload_tensor(obj) -> torch.Tensor:
    """The payload's values as a CPU torch tensor of its dtype."""
    from . import dtype as dtype_mod

    if getattr(obj, "raw", False):
        dt = dtype_mod.to_torch(obj.dtype_name)
        raw = np.ascontiguousarray(obj.array).reshape(-1).view(np.uint8)
        return torch.from_numpy(raw.copy()).view(dt).reshape(
            tuple(obj.shape))
    return torch.from_numpy(np.array(obj.array, copy=True))


def _unpack(obj, return_numpy=False):
    from ..core.tensor import Tensor
    from .place import expected_device

    if isinstance(obj, _TensorPayload):
        if return_numpy:
            if not getattr(obj, "raw", False):
                return obj.array
            return Tensor._wrap(_payload_tensor(obj)).numpy()
        t = Tensor(_payload_tensor(obj).to(expected_device()),
                   stop_gradient=obj.stop_gradient, name=obj.name)
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path, protocol: int = _PROTO, **configs):
    """Pickle `obj` (Tensors, nested dicts / lists / tuples, numbers) to
    `path` (a file name, whose directory is made, or a binary file)."""
    if isinstance(path, str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            _Pickler(f, protocol=protocol).dump(_pack(obj))
    else:
        _Pickler(path, protocol=protocol).dump(_pack(obj))


def load(path, return_numpy: bool = False, **configs):
    """What `save` wrote, in either package: Tensors on the expected place
    (numpy arrays with `return_numpy`)."""
    if isinstance(path, str):
        with open(path, "rb") as f:
            obj = _Unpickler(f).load()
    else:
        obj = _Unpickler(path).load()
    return _unpack(obj, return_numpy=return_numpy)


def loads_plain(data: bytes):
    """Unpickle `data` with the same guard, for files that hold no tensor
    payload (`jit.load`'s program file)."""
    return _Unpickler(io.BytesIO(data)).load()
