"""Dtypes: the port of `paddle_tpu/framework/dtype.py`.

`paddle.float32`-style singletons (`DType`), each naming one
`torch.dtype`. int64 and float64 are first-class, as under the JAX
package's `jax_enable_x64`. `convert_dtype` normalises a string, numpy
dtype, Python type, `torch.dtype` or `DType` to its singleton; the
default float dtype (`set_default_dtype` / `get_default_dtype`) is what
Python floats and float creation ops take.

bfloat16 and the float8 types have no numpy dtype of their own; where
`ml_dtypes` imports, `np_dtype` is its type (the same bits), else None.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DType", "convert_dtype", "to_torch", "from_torch",
           "set_default_dtype", "get_default_dtype", "is_inexact",
           "bool_", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
           "int32", "int64", "float16", "bfloat16", "float32", "float64",
           "float8_e4m3fn", "float8_e5m2", "complex64", "complex128"]

try:
    import ml_dtypes as _ml
except ImportError:         # the numpy view of bf16 / fp8 is then absent
    _ml = None


def _ml_type(name):
    return None if _ml is None else np.dtype(getattr(_ml, name))


class DType:
    """A framework dtype: a hashable singleton that compares equal to
    itself, its name, its `torch.dtype` and its numpy dtype."""

    __slots__ = ("name", "torch_dtype", "np_dtype")

    _registry: dict = {}

    def __init__(self, name: str, torch_dtype, np_dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_dtype = np_dtype
        DType._registry[name] = self

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        if isinstance(other, str):
            return self.name == other
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        try:
            return self.np_dtype is not None \
                and self.np_dtype == np.dtype(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    @property
    def is_floating_point(self) -> bool:
        return self.torch_dtype.is_floating_point or self.is_complex

    @property
    def is_integer(self) -> bool:
        return not (self.torch_dtype.is_floating_point or self.is_complex
                    or self.torch_dtype == torch.bool)

    @property
    def is_complex(self) -> bool:
        return self.torch_dtype.is_complex

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize


bool_ = DType("bool", torch.bool, np.dtype(np.bool_))
uint8 = DType("uint8", torch.uint8, np.dtype(np.uint8))
uint16 = DType("uint16", torch.uint16, np.dtype(np.uint16))
uint32 = DType("uint32", torch.uint32, np.dtype(np.uint32))
uint64 = DType("uint64", torch.uint64, np.dtype(np.uint64))
int8 = DType("int8", torch.int8, np.dtype(np.int8))
int16 = DType("int16", torch.int16, np.dtype(np.int16))
int32 = DType("int32", torch.int32, np.dtype(np.int32))
int64 = DType("int64", torch.int64, np.dtype(np.int64))
float16 = DType("float16", torch.float16, np.dtype(np.float16))
bfloat16 = DType("bfloat16", torch.bfloat16, _ml_type("bfloat16"))
float32 = DType("float32", torch.float32, np.dtype(np.float32))
float64 = DType("float64", torch.float64, np.dtype(np.float64))
float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn,
                      _ml_type("float8_e4m3fn"))
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2,
                    _ml_type("float8_e5m2"))
complex64 = DType("complex64", torch.complex64, np.dtype(np.complex64))
complex128 = DType("complex128", torch.complex128, np.dtype(np.complex128))

_ALIASES = {
    "bool": bool_, "uint8": uint8, "uint16": uint16, "uint32": uint32,
    "uint64": uint64, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "float16": float16, "half": float16, "bfloat16": bfloat16,
    "bf16": bfloat16, "float32": float32, "float": float32, "fp32": float32,
    "float64": float64, "double": float64, "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2, "complex64": complex64,
    "complex128": complex128,
}
_BY_TORCH = {d.torch_dtype: d for d in DType._registry.values()}


def convert_dtype(dtype):
    """A string, numpy dtype, Python type, `torch.dtype` or `DType` ->
    its `DType` singleton (None stays None)."""
    if dtype is None or isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, str):
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        raise ValueError(f"Unknown dtype string: {dtype!r}")
    if isinstance(dtype, torch.dtype):
        return from_torch(dtype)
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return float32
    if dtype is complex:
        return complex64
    name = np.dtype(dtype).name
    if name in _ALIASES:
        return _ALIASES[name]
    raise ValueError(f"Unsupported dtype: {dtype!r}")


def from_torch(dtype: torch.dtype) -> DType:
    try:
        return _BY_TORCH[dtype]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {dtype!r}") from None


def to_torch(dtype) -> torch.dtype:
    return convert_dtype(dtype).torch_dtype


def is_inexact(dtype: torch.dtype) -> bool:
    """Floating or complex: the dtypes that carry gradients."""
    return dtype.is_floating_point or dtype.is_complex


# the default float dtype (`python/paddle/base/framework.py`)
_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(f"set_default_dtype only supports float types, "
                        f"got {d}")
    _default_dtype = d


def get_default_dtype() -> DType:
    return _default_dtype
