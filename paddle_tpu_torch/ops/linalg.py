"""`matmul` and `dot` of `paddle_tpu/ops/linalg.py` (the rest of that
module is not ported yet): plain torch, as the JAX package computes them
outside any Pallas kernel. `matmul`'s `transpose_x` / `transpose_y` swap
the last two axes first; `dot` sums the product over the last axis."""
from __future__ import annotations

import torch

from ..core import dispatch
from ._helpers import prep_binary

__all__ = ["matmul", "dot"]


def _mm(x, y, *, transpose_x, transpose_y):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


dispatch.register_op("matmul", _mm)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return dispatch.apply("matmul", list(prep_binary(x, y)),
                          {"transpose_x": bool(transpose_x),
                           "transpose_y": bool(transpose_y)})


dispatch.register_op("dot", lambda x, y: (x * y).sum(dim=-1))


def dot(x, y, name=None):
    return dispatch.apply("dot", list(prep_binary(x, y)))
