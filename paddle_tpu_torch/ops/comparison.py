"""Comparison and logical ops (the port's subset of
`paddle_tpu/ops/comparison.py`): every output is bool and stops
gradient."""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ._helpers import as_tensor, make_compare, prep_binary

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
           "bitwise_not", "equal_all", "is_tensor"]

equal = make_compare("equal", torch.eq)
not_equal = make_compare("not_equal", torch.ne)
greater_than = make_compare("greater_than", torch.gt)
greater_equal = make_compare("greater_equal", torch.ge)
less_than = make_compare("less_than", torch.lt)
less_equal = make_compare("less_equal", torch.le)
logical_and = make_compare("logical_and", torch.logical_and)
logical_or = make_compare("logical_or", torch.logical_or)
bitwise_and = make_compare("bitwise_and", torch.bitwise_and)
bitwise_or = make_compare("bitwise_or", torch.bitwise_or)
bitwise_xor = make_compare("bitwise_xor", torch.bitwise_xor)

dispatch.register_op("logical_not", torch.logical_not)
dispatch.register_op("bitwise_not", torch.bitwise_not)


def logical_not(x, name=None):
    return dispatch.apply("logical_not", [as_tensor(x)])


def bitwise_not(x, name=None):
    return dispatch.apply("bitwise_not", [as_tensor(x)])


dispatch.register_op("equal_all", lambda x, y: torch.tensor(
    x.shape == y.shape and bool(torch.eq(x, y).all()), device=x.device))


def equal_all(x, y, name=None):
    """One bool: same shape and every element equal."""
    return dispatch.apply("equal_all", list(prep_binary(x, y)))


def is_tensor(x):
    return isinstance(x, Tensor)
