"""Activations: `swiglu` on torch tensors, the plain
`paddle_tpu/ops/activation.py:193-202` the Llama model calls (its MLP does
not reach the Pallas `bias_act` kernels), and `softmax` on eager Tensors
(an integer input is cast to the default float dtype first)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import dispatch
from ..framework import dtype as dtype_mod
from ._helpers import as_tensor, cast_to

__all__ = ["swiglu", "softmax"]


def swiglu(x, y=None):
    """`silu(x) * y`; with `y=None`, x is split in two halves along its
    last axis first."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


dispatch.register_op("softmax", lambda x, *, axis: torch.softmax(x, dim=axis))


def softmax(x, axis=-1, dtype=None, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    elif not dtype_mod.is_inexact(x._data.dtype):
        x = cast_to(x, dtype_mod.get_default_dtype())
    return dispatch.apply("softmax", [x], {"axis": int(axis)})
