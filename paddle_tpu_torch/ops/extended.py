"""`unflatten` of `paddle_tpu/ops/extended.py` (the rest of that module
is not ported yet): one axis reshaped into `shape`."""
from __future__ import annotations

from ._helpers import as_tensor, normalize_axis
from .manipulation import reshape

__all__ = ["unflatten"]


def unflatten(x, axis, shape, name=None):
    x = as_tensor(x)
    axis = normalize_axis(axis, x.ndim)
    shape = tuple(int(s) for s in shape)
    return reshape(x, tuple(x.shape[:axis]) + shape
                   + tuple(x.shape[axis + 1:]))
