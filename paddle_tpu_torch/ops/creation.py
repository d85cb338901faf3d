"""Tensor creation (the port's subset of `paddle_tpu/ops/creation.py`):
`to_tensor`, `zeros`, `ones`, `full`, `arange`, `eye`, `linspace`,
`assign`, and the seeded draws `rand`, `randn`, `randint`, `uniform`,
`normal`, which take a key from the default generator and give the
JAX package's values (`framework/random.py`). New tensors go to the
expected place (`set_device`), the CUDA card by default.

Default dtypes as the JAX package's: Python floats (and numpy float64
arrays given to `to_tensor`) take the default float dtype, Python ints
int64; `full` / `zeros` / `ones` are float unless asked otherwise, even
for an int fill; `arange` of ints is int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch
from ..core.tensor import Tensor, _to_torch
from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ..framework.place import expected_device
from ._helpers import as_tensor, cast_to, shape_to_tuple

__all__ = ["to_tensor", "full", "zeros", "ones", "arange", "eye",
           "linspace", "assign", "clone", "rand", "randn", "randint",
           "uniform", "normal"]


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    if isinstance(data, Tensor):
        t = data
        if dtype is not None and t.dtype != dtype_mod.convert_dtype(dtype):
            t = cast_to(t, dtype)
        return Tensor(t._data, stop_gradient=stop_gradient)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(expected_device(place))
    else:
        arr = np.asarray(data)
        t = _to_torch(arr, place)
        if dtype is None and arr.dtype == np.float64:
            dtype = dtype_mod.get_default_dtype()
    if dtype is not None:
        t = t.to(dtype_mod.to_torch(dtype))
    return Tensor(t, stop_gradient=stop_gradient)


def _float_dtype(dtype) -> torch.dtype:
    return dtype_mod.to_torch(dtype) if dtype is not None \
        else dtype_mod.get_default_dtype().torch_dtype


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        dt = torch.bool if isinstance(fill_value, bool) else _float_dtype(None)
    else:
        dt = dtype_mod.to_torch(dtype)
    return Tensor._wrap(torch.full(shape_to_tuple(shape), fill_value,
                                   dtype=dt, device=expected_device()))


def zeros(shape, dtype=None, name=None) -> Tensor:
    return full(shape, 0, dtype=dtype or dtype_mod.get_default_dtype())


def ones(shape, dtype=None, name=None) -> Tensor:
    return full(shape, 1, dtype=dtype or dtype_mod.get_default_dtype())


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange with Tensor bounds is not supported; "
                            "pass python numbers")
    if dtype is None:
        dt = torch.int64 if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) \
            else _float_dtype(None)
    else:
        dt = dtype_mod.to_torch(dtype)
    return Tensor._wrap(torch.arange(start, end, step, dtype=dt,
                                     device=expected_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    m = int(num_columns) if num_columns is not None else int(num_rows)
    return Tensor._wrap(torch.eye(int(num_rows), m, dtype=_float_dtype(dtype),
                                  device=expected_device()))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    start, stop, num = (v.item() if isinstance(v, Tensor) else v
                        for v in (start, stop, num))
    return Tensor._wrap(torch.linspace(float(start), float(stop), int(num),
                                       dtype=_float_dtype(dtype),
                                       device=expected_device()))


dispatch.register_op("assign", torch.clone)


def assign(x, output=None) -> Tensor:
    out = dispatch.apply("assign", [as_tensor(x)])
    if output is not None:
        output._data = out._data
        return output
    return out


def clone(x, name=None) -> Tensor:
    return assign(x)


# ---------------------------------------------------------------------------
# seeded draws: one key from the default generator per call
# ---------------------------------------------------------------------------

def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    return Tensor._wrap(random_mod.uniform(
        random_mod.next_key(), shape_to_tuple(shape), _float_dtype(dtype),
        float(min), float(max), expected_device()))


def rand(shape, dtype=None, name=None) -> Tensor:
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None) -> Tensor:
    return Tensor._wrap(random_mod.normal(
        random_mod.next_key(), shape_to_tuple(shape), _float_dtype(dtype),
        expected_device()))


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = as_tensor(mean), as_tensor(std)
        g = randn(m.shape if isinstance(mean, Tensor) else s.shape)
        return g * s + m
    g = randn(shape)
    return Tensor._wrap(g._data * float(std) + float(mean))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    dt = dtype_mod.to_torch(dtype) if dtype is not None else torch.int64
    return Tensor._wrap(random_mod.randint(
        random_mod.next_key(), shape_to_tuple(shape), int(low), int(high),
        dt, expected_device()))
