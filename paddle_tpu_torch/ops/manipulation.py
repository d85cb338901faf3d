"""Shape and index manipulation (the port's subset of
`paddle_tpu/ops/manipulation.py`): `cast` / `astype`, `reshape`,
`squeeze`, `flatten`, `transpose`, `concat`, `stack`, `split`,
`gather`, `where`, and `__getitem__` / `__setitem__`.

Indexing takes ints, slices with steps, None, Ellipsis, integer tensors
and lists, and bool masks, through torch's own indexing (a bool mask is
differentiable in x). `__setitem__` writes into a copy and rebinds, as
the JAX package's `.at[].set` does, so a written slot of a non-leaf gets
a zero gradient and the value written gets its own; on a leaf that
requires grad it raises outside `no_grad`. The JAX package clamps an
out-of-range tensor index; torch raises.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from ._helpers import (as_tensor, inplace_rebind, normalize_axis,
                       prep_binary, result_dtype, shape_to_tuple)

__all__ = ["cast", "astype", "reshape", "squeeze", "flatten", "transpose",
           "concat", "stack",
           "split", "gather", "where", "getitem", "setitem"]

dispatch.register_op("cast", lambda x, *, dtype: x.to(dtype))


def cast(x, dtype, name=None):
    x = as_tensor(x)
    d = dtype_mod.convert_dtype(dtype)
    if x.dtype == d:
        return x
    return dispatch.apply("cast", [x], {"dtype": d.torch_dtype})


astype = cast

dispatch.register_op("reshape", lambda x, *, shape: torch.reshape(x, shape))


def reshape(x, shape, name=None):
    return dispatch.apply("reshape", [as_tensor(x)],
                          {"shape": shape_to_tuple(shape)})


dispatch.register_op("squeeze", lambda x, *, axis: torch.squeeze(x, axis)
                     if axis is not None else torch.squeeze(x))


def squeeze(x, axis=None, name=None):
    x = as_tensor(x)
    if axis is not None:
        ax = normalize_axis(axis, x.ndim)
        ax = tuple(a for a in ((ax,) if isinstance(ax, int) else ax)
                   if x._data.shape[a] == 1)
        if not ax:
            return x
        axis = ax
    return dispatch.apply("squeeze", [x], {"axis": axis})


dispatch.register_op("flatten", lambda x, *, start, stop: torch.flatten(
    x, start, stop))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = as_tensor(x)
    if x.ndim == 0:
        return reshape(x, [1])
    return dispatch.apply("flatten", [x], {
        "start": normalize_axis(start_axis, x.ndim),
        "stop": normalize_axis(stop_axis, x.ndim)})


dispatch.register_op("transpose", lambda x, *, perm: x.permute(perm))


def transpose(x, perm=None, name=None):
    x = as_tensor(x)
    if perm is None:
        perm = tuple(reversed(range(x.ndim)))
    return dispatch.apply("transpose", [x],
                          {"perm": tuple(int(p) for p in perm)})


dispatch.register_op("concat", lambda *xs, axis: torch.cat(xs, dim=axis))


def concat(x, axis=0, name=None):
    tensors = [as_tensor(t) for t in x]
    common = tensors[0]._data.dtype
    for t in tensors[1:]:
        common = result_dtype(common, t._data.dtype)
    tensors = [cast(t, common) for t in tensors]
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return dispatch.apply("concat", tensors, {"axis": int(axis)})


dispatch.register_op("stack", lambda *xs, axis: torch.stack(xs, dim=axis))


def stack(x, axis=0, name=None):
    return dispatch.apply("stack", [as_tensor(t) for t in x],
                          {"axis": int(axis)})


dispatch.register_op("split", lambda x, *, indices, axis: tuple(
    torch.tensor_split(x, indices, dim=axis)), multi_out=True)


def split(x, num_or_sections, axis=0, name=None):
    """`num_or_sections` equal parts (which must divide the axis), or a
    list of section sizes, one of which may be -1."""
    x = as_tensor(x)
    ax = normalize_axis(axis, x.ndim)
    dim = x._data.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"split: {dim} is not divisible into "
                             f"{num_or_sections} equal sections")
        indices = num_or_sections
    else:
        secs = [int(s.item()) if isinstance(s, Tensor) else int(s)
                for s in num_or_sections]
        known = builtins.sum(s for s in secs if s != -1)
        secs = [dim - known if s == -1 else s for s in secs]
        indices = tuple(np.cumsum(secs[:-1]).tolist())
    return dispatch.apply("split", [x], {"indices": indices, "axis": ax})


def _take(x, idx, *, axis):
    """`jnp.take(x, idx, axis)`: the index's shape replaces the axis."""
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


dispatch.register_op("gather", _take)


def gather(x, index, axis=0, name=None):
    x = as_tensor(x)
    index = as_tensor(index, device=x._data.device)
    if index.ndim == 2 and index._data.shape[1] == 1:
        index = squeeze(index, 1)
    return dispatch.apply("gather", [x, index], {
        "axis": normalize_axis(axis, x.ndim) if axis is not None else 0})


dispatch.register_op("where", lambda c, x, y: torch.where(
    c if c.dtype == torch.bool else c != 0, x, y))


def where(condition, x=None, y=None, name=None):
    condition = as_tensor(condition)
    if x is None and y is None:
        return tuple(Tensor._wrap(i) for i in torch.nonzero(
            condition._data, as_tuple=True))
    x, y = prep_binary(x, y)
    return dispatch.apply("where", [condition, x, y])


# -- indexing ----------------------------------------------------------------

def _encode_index(idx, tensors, device):
    """The index as a hashable spec; tensor indices go into `tensors`."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    spec = []
    for it in idx:
        if isinstance(it, (list, np.ndarray)):
            it = as_tensor(np.asarray(it), device=device)
        if isinstance(it, Tensor):
            spec.append(("tensor", len(tensors)))
            tensors.append(it)
        elif isinstance(it, builtins.slice):
            spec.append(("slice", *(None if v is None else int(v)
                                    for v in (it.start, it.stop, it.step))))
        elif it is None or it is Ellipsis:
            spec.append(("const", it))
        elif isinstance(it, (bool, np.bool_)):
            spec.append(("const", bool(it)))
        elif isinstance(it, (int, np.integer)):
            spec.append(("const", int(it)))
        else:
            raise TypeError(f"unsupported index type {type(it)}")
    return tuple(spec)


def _decode_index(spec, arrays):
    out = []
    for s in spec:
        if s[0] == "tensor":
            out.append(arrays[s[1]])
        elif s[0] == "slice":
            out.append(builtins.slice(s[1], s[2], s[3]))
        else:
            out.append(s[1])
    return tuple(out)


dispatch.register_op("getitem", lambda x, *arrays, spec:
                     x[_decode_index(spec, arrays)])


def getitem(x, idx):
    x = as_tensor(x)
    tensors = []
    spec = _encode_index(idx, tensors, x._data.device)
    return dispatch.apply("getitem", [x] + tensors, {"spec": spec})


def _setitem(x, v, *arrays, spec):
    out = x.clone()
    out[_decode_index(spec, arrays)] = v
    return out


dispatch.register_op("setitem", _setitem)


def setitem(x, idx, value):
    tensors = []
    spec = _encode_index(idx, tensors, x._data.device)
    if not isinstance(value, Tensor):
        value = as_tensor(value, dtype=x.dtype, device=x._data.device)
    value = cast(value, x.dtype)
    out = dispatch.apply("setitem", [x, value] + tensors, {"spec": spec})
    inplace_rebind(x, out)
