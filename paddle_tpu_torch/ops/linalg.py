"""`matmul` (the port's one op of `paddle_tpu/ops/linalg.py`): plain
`torch.matmul`, as the JAX package computes it outside any Pallas
kernel; `transpose_x` / `transpose_y` swap the last two axes first."""
from __future__ import annotations

import torch

from ..core import dispatch
from ._helpers import prep_binary

__all__ = ["matmul"]


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
