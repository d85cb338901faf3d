"""Comparison, logical and bitwise ops: the port of
`paddle_tpu/ops/comparison.py`. Every comparison output is bool and
stops gradient. `bitwise_right_shift(is_arithmetic=False)` shifts in
zeros whatever the sign (the bits read as unsigned, as the JAX package
does through a uint view); `isclose` / `allclose` are numpy's
`|x - y| <= atol + rtol * |y|`."""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ._helpers import as_tensor, make_compare, prep_binary

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "bitwise_left_shift",
           "bitwise_right_shift", "isclose", "allclose", "equal_all",
           "is_empty", "is_tensor"]

equal = make_compare("equal", torch.eq)
not_equal = make_compare("not_equal", torch.ne)
greater_than = make_compare("greater_than", torch.gt)
greater_equal = make_compare("greater_equal", torch.ge)
less_than = make_compare("less_than", torch.lt)
less_equal = make_compare("less_equal", torch.le)
logical_and = make_compare("logical_and", torch.logical_and)
logical_or = make_compare("logical_or", torch.logical_or)
logical_xor = make_compare("logical_xor", torch.logical_xor)
bitwise_and = make_compare("bitwise_and", torch.bitwise_and)
bitwise_or = make_compare("bitwise_or", torch.bitwise_or)
bitwise_xor = make_compare("bitwise_xor", torch.bitwise_xor)

dispatch.register_op("logical_not", torch.logical_not)
dispatch.register_op("bitwise_not", torch.bitwise_not)
dispatch.register_op("bitwise_left_shift", torch.bitwise_left_shift)
dispatch.register_op("bitwise_right_shift", torch.bitwise_right_shift)


def logical_not(x, name=None):
    return dispatch.apply("logical_not", [as_tensor(x)])


def bitwise_not(x, name=None):
    return dispatch.apply("bitwise_not", [as_tensor(x)])


def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return dispatch.apply("bitwise_left_shift", list(prep_binary(x, y)))


def _logical_right_shift(x, y):
    """Zeros shifted in from the left: the arithmetic shift with the
    sign-extended bits masked off by `(1 << (bits - y)) - 1`."""
    bits = x.element_size() * 8
    one = torch.ones((), dtype=x.dtype, device=x.device)
    mask = torch.bitwise_left_shift(one, (bits - y).clamp(0, bits - 1)) - 1
    out = torch.bitwise_right_shift(x, y) & mask
    return torch.where(y <= 0, x, torch.where(y >= bits,
                                              torch.zeros_like(x), out))


dispatch.register_op("bitwise_right_shift_logic", _logical_right_shift)


def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    op = "bitwise_right_shift" if is_arithmetic \
        else "bitwise_right_shift_logic"
    return dispatch.apply(op, list(prep_binary(x, y)))


def _isclose(x, y, *, rtol, atol, equal_nan):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


dispatch.register_op("isclose", _isclose)
dispatch.register_op("allclose", lambda x, y, **kw: _isclose(
    x, y, **kw).all())


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return dispatch.apply("isclose", list(prep_binary(x, y)),
                          {"rtol": float(rtol), "atol": float(atol),
                           "equal_nan": bool(equal_nan)})


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return dispatch.apply("allclose", list(prep_binary(x, y)),
                          {"rtol": float(rtol), "atol": float(atol),
                           "equal_nan": bool(equal_nan)})


dispatch.register_op("equal_all", lambda x, y: torch.tensor(
    x.shape == y.shape and bool(torch.eq(x, y).all()), device=x.device))


def equal_all(x, y, name=None):
    """One bool: same shape and every element equal."""
    return dispatch.apply("equal_all", list(prep_binary(x, y)))


def is_empty(x, name=None):
    x = as_tensor(x)
    return Tensor._wrap(torch.tensor(x.size == 0, device=x._data.device))


def is_tensor(x):
    return isinstance(x, Tensor)
