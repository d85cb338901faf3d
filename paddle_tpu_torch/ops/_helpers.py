"""Shared op-wrapper machinery (the port of `paddle_tpu/ops/_helpers.py`):
scalars as tensors, paddle's type promotion, the op factories and the
in-place rebind.

Promotion as paddle does it: a float beats an int (int64 + float32 ->
float32), a Python float against an integer tensor takes the default
float dtype (int64 + 0.5 -> float32), a Python int takes the tensor's
dtype (int64 + 1 -> int64), bf16 against f16 is f32, and division is
always in a float dtype (int64 / int64 -> float32).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod

__all__ = ["as_tensor", "result_dtype", "prep_binary",
           "make_unary", "make_float_unary", "make_binary", "make_compare",
           "inplace_rebind", "normalize_axis", "shape_to_tuple", "cast_to"]


def cast_to(x: Tensor, dtype) -> Tensor:
    from .manipulation import cast

    return cast(x, dtype)


def as_tensor(x, dtype=None, device=None) -> Tensor:
    """`x` as a Tensor: a Tensor as is (cast to `dtype` if given); a
    Python bool / int / float as bool / int64 / the default float dtype;
    anything else through numpy's dtype rules. New tensors go to `device`
    (default: the expected place)."""
    if isinstance(x, Tensor):
        if dtype is not None and x.dtype != dtype_mod.convert_dtype(dtype):
            return cast_to(x, dtype)
        return x
    if dtype is not None:
        tdt = dtype_mod.to_torch(dtype)
    elif isinstance(x, bool):
        tdt = torch.bool
    elif isinstance(x, int):
        tdt = torch.int64
    elif isinstance(x, float):
        tdt = dtype_mod.get_default_dtype().torch_dtype
    else:
        t = Tensor(x, place=device)
        return t
    return Tensor._wrap(torch.tensor(x, dtype=tdt, device=_device(device)))


def _device(device):
    from ..framework.place import expected_device

    return expected_device(device)


def result_dtype(xd: torch.dtype, yd: torch.dtype) -> torch.dtype:
    """Paddle-style promotion of two tensor dtypes: a float beats an int,
    and nothing widens silently to float64."""
    if xd == yd:
        return xd
    xf, yf = dtype_mod.is_inexact(xd), dtype_mod.is_inexact(yd)
    if xf and yf:
        return torch.promote_types(xd, yd)
    if xf:
        return xd
    if yf:
        return yd
    return dtype_mod.to_torch(np.promote_types(
        dtype_mod.from_torch(xd).np_dtype, dtype_mod.from_torch(yd).np_dtype))


def _scalar_like(scalar, t: Tensor) -> Tensor:
    """A scalar operand beside tensor `t`, on t's device."""
    td = t._data.dtype
    if isinstance(scalar, (bool, np.bool_)):
        d = td
    elif isinstance(scalar, (float, np.floating)) \
            and not dtype_mod.is_inexact(td):
        d = dtype_mod.get_default_dtype().torch_dtype
    elif isinstance(scalar, complex):
        d = torch.complex64
    elif isinstance(scalar, (np.ndarray, list, tuple)):
        return as_tensor(scalar, device=t._data.device)
    else:
        d = td
    return Tensor._wrap(torch.tensor(scalar, dtype=d, device=t._data.device))


def prep_binary(x, y):
    """The (tensor | scalar, tensor | scalar) pair as two Tensors of one
    dtype."""
    if not isinstance(x, Tensor) and not isinstance(y, Tensor):
        x, y = as_tensor(x), as_tensor(y)
    elif not isinstance(y, Tensor):
        y = _scalar_like(y, x)
    elif not isinstance(x, Tensor):
        x = _scalar_like(x, y)
    rd = result_dtype(x._data.dtype, y._data.dtype)
    if x._data.dtype != rd:
        x = cast_to(x, rd)
    if y._data.dtype != rd:
        y = cast_to(y, rd)
    return x, y


def _to_float(x: Tensor) -> Tensor:
    if dtype_mod.is_inexact(x._data.dtype):
        return x
    return cast_to(x, dtype_mod.get_default_dtype())


def make_unary(op_name: str, fn):
    dispatch.register_op(op_name, fn)

    def api(x, name=None):
        return dispatch.apply(op_name, [as_tensor(x)])

    api.__name__ = op_name
    return api


def make_float_unary(op_name: str, fn):
    """A unary op that casts an integer input to the default float dtype
    first (paddle semantics)."""
    dispatch.register_op(op_name, fn)

    def api(x, name=None):
        return dispatch.apply(op_name, [_to_float(as_tensor(x))])

    api.__name__ = op_name
    return api


def make_binary(op_name: str, fn, float_only=False):
    dispatch.register_op(op_name, fn)

    def api(x, y, name=None):
        x, y = prep_binary(x, y)
        if float_only and not dtype_mod.is_inexact(x._data.dtype):
            x, y = _to_float(x), _to_float(y)
        return dispatch.apply(op_name, [x, y])

    api.__name__ = op_name
    return api


def make_compare(op_name: str, fn):
    dispatch.register_op(op_name, fn)

    def api(x, y, name=None):
        return dispatch.apply(op_name, list(prep_binary(x, y)))

    api.__name__ = op_name
    return api


def inplace_rebind(x: Tensor, out: Tensor) -> Tensor:
    """Paddle's in-place semantics: `x` takes `out`'s values and graph.
    A leaf that requires grad raises when the op was recorded
    (`fluid/eager/utils.cc CheckInplace`); under `no_grad` its values are
    overwritten in place, so it stays the same leaf (the optimizer
    pattern). Every other tensor is rebound to `out`'s tensor."""
    d = x._data
    if d.requires_grad and d.grad_fn is None:
        if out._data.requires_grad:
            raise RuntimeError(
                "Leaf Tensor that doesn't stop gradient can't use inplace "
                "strategy; wrap the update in paddle.no_grad()")
        if out._data.shape == d.shape and out._data.dtype == d.dtype:
            with torch.no_grad():
                d.copy_(out._data)
            return x
    x._data = out._data
    return x


def normalize_axis(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) + ndim if int(a) < 0 else int(a) for a in axis)
    axis = int(axis)
    return axis + ndim if axis < 0 else axis


def shape_to_tuple(shape):
    """A shape as a tuple of ints; a symbolic size (a `torch.SymInt`, as
    a captured program's dynamic dims give) stays symbolic."""
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.numpy().tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor)
                 else s if isinstance(s, torch.SymInt) else int(s)
                 for s in shape)
