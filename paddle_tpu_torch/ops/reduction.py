"""Reductions (the port's subset of `paddle_tpu/ops/reduction.py`): `sum`,
`mean`, `max`, `min`, `all`, `any`, `argmax`. `axis=None` reduces every
axis, and `keepdim` keeps them as size 1. `max` / `min` share the
gradient equally among tied elements, as `jnp.max` does. `sum` of bool
counts in int64; `mean` of an integer tensor is in the default float
dtype; `argmax` returns the first maximal index, int64 by default, and
stops gradient."""
from __future__ import annotations

import torch

from ..core import dispatch
from ..framework import dtype as dtype_mod
from ._helpers import as_tensor, cast_to, normalize_axis

__all__ = ["sum", "mean", "max", "min", "all", "any", "argmax"]


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


dispatch.register_op("reduce_sum", lambda x, *, axis, keepdim: torch.sum(
    x, dim=_dims(x, axis), keepdim=keepdim) if x.dim() else x.clone())
dispatch.register_op("reduce_mean", lambda x, *, axis, keepdim: torch.mean(
    x, dim=_dims(x, axis), keepdim=keepdim) if x.dim() else x.clone())
dispatch.register_op("reduce_max", lambda x, *, axis, keepdim: torch.amax(
    x, dim=_dims(x, axis), keepdim=keepdim))
dispatch.register_op("reduce_min", lambda x, *, axis, keepdim: torch.amin(
    x, dim=_dims(x, axis), keepdim=keepdim))


def _reduce_bool(fn):
    def f(x, *, axis, keepdim):
        x = x.bool()
        for a in sorted(_dims(x, axis), reverse=True):
            x = fn(x, dim=a, keepdim=keepdim)
        return x
    return f


dispatch.register_op("reduce_all", _reduce_bool(torch.all))
dispatch.register_op("reduce_any", _reduce_bool(torch.any))


def _reduce(opname, x, axis, keepdim):
    return dispatch.apply(opname, [x], {"axis": normalize_axis(axis, x.ndim),
                                        "keepdim": bool(keepdim)})


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    elif x.dtype == dtype_mod.bool_:
        x = cast_to(x, "int64")
    return _reduce("reduce_sum", x, axis, keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    if not dtype_mod.is_inexact(x._data.dtype):
        x = cast_to(x, dtype_mod.get_default_dtype())
    return _reduce("reduce_mean", x, axis, keepdim)


def max(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_max", as_tensor(x), axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_min", as_tensor(x), axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_all", as_tensor(x), axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_any", as_tensor(x), axis, keepdim)


def _argmax(x, *, axis, keepdim, dtype):
    if axis is None:
        out = torch.argmax(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = torch.argmax(x, dim=axis, keepdim=keepdim)
    return out.to(dtype)


dispatch.register_op("argmax", _argmax)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = as_tensor(x)
    return dispatch.apply("argmax", [x], {
        "axis": normalize_axis(axis, x.ndim), "keepdim": bool(keepdim),
        "dtype": dtype_mod.to_torch(dtype)})
