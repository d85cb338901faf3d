"""Shape and index manipulation: the port of
`paddle_tpu/ops/manipulation.py`.

- Views and shape ops: `cast` / `astype`, `reshape` / `view`, `squeeze`,
  `unsqueeze` (several axes at their output positions, as
  `jnp.expand_dims`), `flatten`, `transpose`, `t`, `moveaxis`,
  `swapaxes`, `concat`, `stack`, `split` / `chunk`, `unbind` /
  `unstack`, `broadcast_*`, `expand*`, `tile`, `repeat_interleave`,
  `flip`, `rot90`, `roll`, `pad` (`jnp.pad`'s constant, reflect, edge and
  wrap modes on any axis), `slice`, `strided_slice`, `crop`.
- Indexing: `gather`, `gather_nd`, `take_along_axis`, `put_along_axis`
  (assign, add, mul, amax, amin), `index_select`, `index_sample`,
  `scatter` (overwrite, or zero the indexed rows and add),
  `scatter_nd(_add)`, `select_scatter`, `masked_fill`, `masked_select`,
  `where`, and `__getitem__` / `__setitem__`.
- Ordering: `topk` (ties to the lower index, as `lax.top_k`), `sort` and
  `argsort` (stable), `searchsorted`, `bucketize` (`jnp.digitize` with
  the side flipped, as JAX calls it), `unique`, `unique_consecutive`,
  `nonzero`.
- `one_hot` (float32), `diagonal`, `diag_embed`, `as_complex` /
  `as_real`, and `shape` / `numel` / `rank` as int64 tensors.

`nonzero`, `masked_select`, `unique` and `unique_consecutive` have
shapes that depend on the values: they read the mask or values on the
host, as the JAX package does, and under lazy mode flush what they read
(they are never recorded). The JAX package clamps an out-of-range
gather index and drops an out-of-range scatter index; the port's
gathers and scatters raise on one (on the card, a device assert).

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

__all__ = ["cast", "astype", "reshape", "reshape_", "view", "transpose",
           "t", "t_", "moveaxis", "swapaxes", "flatten", "squeeze",
           "squeeze_", "unsqueeze", "unsqueeze_", "concat", "stack",
           "split", "chunk", "unbind", "unstack", "broadcast_to", "expand",
           "expand_as", "broadcast_tensors", "broadcast_shape", "tile",
           "repeat_interleave", "flip", "rot90", "roll", "pad", "gather",
           "gather_nd", "take_along_axis", "put_along_axis", "index_select",
           "index_sample", "scatter", "scatter_nd_add", "scatter_nd",
           "where", "where_", "select_scatter", "topk", "sort", "argsort",
           "searchsorted", "bucketize", "nonzero", "masked_select",
           "masked_fill", "unique", "unique_consecutive", "getitem",
           "setitem", "slice", "strided_slice", "crop", "shape", "numel",
           "rank", "as_complex", "as_real", "one_hot", "diagonal",
           "diag_embed"]

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


def reshape_(x, shape, name=None):
    return inplace_rebind(x, reshape(x, shape))


view = reshape


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


def squeeze_(x, axis=None, name=None):
    return inplace_rebind(x, squeeze(x, axis))


def _unsqueeze(x, *, axis):
    nd = x.dim() + len(axis)
    for a in sorted(a % nd for a in axis):
        x = x.unsqueeze(a)
    return x


dispatch.register_op("unsqueeze", _unsqueeze)


def unsqueeze(x, axis, name=None):
    x = as_tensor(x)
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    ax = tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (int(axis),)
    return dispatch.apply("unsqueeze", [x], {"axis": ax})


def unsqueeze_(x, axis, name=None):
    return inplace_rebind(x, unsqueeze(x, axis))


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


def t(x, name=None):
    x = as_tensor(x)
    if x.ndim < 2:
        return x
    if x.ndim != 2:
        raise ValueError("t() expects a 0/1/2-D tensor; use transpose for "
                         "N-D")
    return transpose(x, [1, 0])


def t_(x, name=None):
    return inplace_rebind(x, t(x))


dispatch.register_op("moveaxis", lambda x, *, src, dst: torch.movedim(
    x, src, dst))


def moveaxis(x, source, destination, name=None):
    return dispatch.apply("moveaxis", [as_tensor(x)], {
        "src": tuple(np.atleast_1d(source).tolist()),
        "dst": tuple(np.atleast_1d(destination).tolist())})


def swapaxes(x, axis0, axis1, name=None):
    x = as_tensor(x)
    perm = list(range(x.ndim))
    a0, a1 = normalize_axis(axis0, x.ndim), normalize_axis(axis1, x.ndim)
    perm[a0], perm[a1] = perm[a1], perm[a0]
    return transpose(x, perm)


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


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


dispatch.register_op("unbind", lambda x, *, ax: tuple(torch.unbind(x, ax)),
                     multi_out=True)


def unbind(x, axis=0, name=None):
    x = as_tensor(x)
    return dispatch.apply("unbind", [x], {"ax": normalize_axis(axis,
                                                               x.ndim)})


def unstack(x, axis=0, num=None, name=None):
    return unbind(x, axis)


# -- broadcast / tile --------------------------------------------------------
dispatch.register_op("broadcast_to", lambda x, *, shape: torch.broadcast_to(
    x, shape))


def broadcast_to(x, shape, name=None):
    return dispatch.apply("broadcast_to", [as_tensor(x)],
                          {"shape": shape_to_tuple(shape)})


def expand(x, shape, name=None):
    """`broadcast_to`, where -1 keeps the input's size."""
    x = as_tensor(x)
    shape = list(shape_to_tuple(shape))
    xs = [1] * (len(shape) - x.ndim) + list(x._data.shape)
    return broadcast_to(x, [xs[i] if s == -1 else s
                            for i, s in enumerate(shape)])


def expand_as(x, y, name=None):
    return broadcast_to(x, as_tensor(y).shape)


def broadcast_tensors(inputs, name=None):
    ts = [as_tensor(t) for t in inputs]
    shape = np.broadcast_shapes(*[tuple(t.shape) for t in ts])
    return [broadcast_to(t, shape) for t in ts]


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


dispatch.register_op("tile", lambda x, *, reps: torch.tile(x, reps))


def tile(x, repeat_times, name=None):
    return dispatch.apply("tile", [as_tensor(x)],
                          {"reps": shape_to_tuple(repeat_times)})


def _repeat(x, *, repeats, axis):
    if isinstance(repeats, tuple):
        repeats = torch.tensor(repeats, dtype=torch.int64, device=x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


dispatch.register_op("repeat_interleave", _repeat)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = as_tensor(x)
    if isinstance(repeats, Tensor):
        repeats = tuple(repeats.numpy().tolist())
    return dispatch.apply("repeat_interleave", [x], {
        "repeats": repeats, "axis": normalize_axis(axis, x.ndim)})


dispatch.register_op("flip", lambda x, *, axis: torch.flip(x, axis))


def flip(x, axis, name=None):
    x = as_tensor(x)
    ax = normalize_axis(axis if isinstance(axis, (list, tuple)) else [axis],
                        x.ndim)
    return dispatch.apply("flip", [x], {"axis": ax})


dispatch.register_op("rot90", lambda x, *, k, axes: torch.rot90(x, k, axes))


def rot90(x, k=1, axes=(0, 1), name=None):
    return dispatch.apply("rot90", [as_tensor(x)],
                          {"k": int(k), "axes": tuple(axes)})


dispatch.register_op("roll", lambda x, *, shifts, axis: torch.roll(
    x, shifts, axis) if axis is not None else torch.roll(x, shifts))


def roll(x, shifts, axis=None, name=None):
    x = as_tensor(x)
    if isinstance(shifts, Tensor):
        shifts = tuple(int(v) for v in shifts.numpy().tolist())
    elif isinstance(shifts, (list, tuple)):
        shifts = tuple(int(s) for s in shifts)
    else:
        shifts = int(shifts)
    ax = normalize_axis(axis, x.ndim) if axis is not None else None
    return dispatch.apply("roll", [x], {"shifts": shifts, "axis": ax})


# -- pad ---------------------------------------------------------------------
def _pad(x, *, widths, jmode, value):
    if jmode == "constant":
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            # the source positions of jnp.pad(arange(n), (lo, hi), mode)
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=jmode)
            x = torch.index_select(x, ax, torch.as_tensor(idx,
                                                          device=x.device))
    return x


dispatch.register_op("pad", _pad)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """`pad` of 2 * ndim widths is per axis in order; fewer pairs run over
    the last axes from the last (torch's order), or over the spatial axes
    of an NHWC tensor."""
    x = as_tensor(x)
    if isinstance(pad, Tensor):
        pad = pad.numpy().tolist()
    pad = tuple(int(p) for p in pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        widths = tuple((pad[2 * i], pad[2 * i + 1]) for i in range(nd))
    else:
        n_pairs = len(pad) // 2
        widths_rev = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_pairs)]
        widths = [(0, 0)] * (nd - n_pairs) + list(reversed(widths_rev))
        if data_format == "NHWC" and n_pairs < nd - 1:
            widths = ([(0, 0)] + list(reversed(widths_rev))
                      + [(0, 0)] * (nd - n_pairs - 1))
        widths = tuple(widths)
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    return dispatch.apply("pad", [x], {"widths": widths, "jmode": jmode,
                                       "value": float(value)})


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


dispatch.register_op("gather_nd", lambda x, idx: x[tuple(
    idx[..., i] for i in range(idx.shape[-1]))])


def gather_nd(x, index, name=None):
    x = as_tensor(x)
    return dispatch.apply("gather_nd", [x, as_tensor(
        index, device=x._data.device)])


dispatch.register_op("take_along_axis", lambda x, idx, *, axis: torch.gather(
    x, axis, idx))


def take_along_axis(x, indices, axis, broadcast=True, name=None):
    x = as_tensor(x)
    idx = as_tensor(indices, device=x._data.device)
    ax = normalize_axis(axis, x.ndim)
    if broadcast and idx.ndim == x.ndim:
        # indices broadcast against x but on `axis`
        tgt = list(x.shape)
        tgt[ax] = idx._data.shape[ax]
        if list(idx.shape) != tgt:
            idx = broadcast_to(idx, tgt)
    return dispatch.apply("take_along_axis", [x, idx], {"axis": ax})


_REDUCE = {"add": "sum", "multiply": "prod", "mul": "prod", "amax": "amax",
           "amin": "amin"}


def _put_along_axis(x, idx, v, *, axis, reduce):
    v = torch.broadcast_to(v, idx.shape)
    if reduce == "assign":
        return x.scatter(axis, idx, v)
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce}")
    return x.scatter_reduce(axis, idx, v, _REDUCE[reduce], include_self=True)


dispatch.register_op("put_along_axis", _put_along_axis)


def put_along_axis(x, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    x = as_tensor(x)
    idx = as_tensor(indices, device=x._data.device)
    if not isinstance(values, Tensor):
        values = as_tensor(values, dtype=x.dtype, device=x._data.device)
    values = cast(values, x.dtype)
    return dispatch.apply("put_along_axis", [x, idx, values], {
        "axis": normalize_axis(axis, x.ndim), "reduce": reduce})


dispatch.register_op("index_select", _take)


def index_select(x, index, axis=0, name=None):
    x = as_tensor(x)
    return dispatch.apply("index_select", [x, as_tensor(
        index, device=x._data.device)], {"axis": normalize_axis(axis,
                                                                x.ndim)})


dispatch.register_op("index_sample", lambda x, idx: torch.gather(x, 1, idx))


def index_sample(x, index, name=None):
    x = as_tensor(x)
    return dispatch.apply("index_sample", [x, as_tensor(
        index, device=x._data.device)])


def _scatter(x, idx, upd, *, overwrite):
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx.reshape(-1)
    if overwrite:
        return x.index_put((idx,), upd)
    return x.index_put((idx,), torch.zeros_like(upd)).index_put(
        (idx,), upd, accumulate=True)


dispatch.register_op("scatter", _scatter)


def scatter(x, index, updates, overwrite=True, name=None):
    x = as_tensor(x)
    return dispatch.apply("scatter", [x, as_tensor(
        index, device=x._data.device), as_tensor(updates)],
        {"overwrite": bool(overwrite)})


dispatch.register_op("scatter_nd_add", lambda x, idx, upd: x.index_put(
    tuple(idx[..., i] for i in range(idx.shape[-1])), upd, accumulate=True))


def scatter_nd_add(x, index, updates, name=None):
    x = as_tensor(x)
    return dispatch.apply("scatter_nd_add", [x, as_tensor(
        index, device=x._data.device), as_tensor(updates)])


def scatter_nd(index, updates, shape, name=None):
    from .creation import zeros

    updates = as_tensor(updates)
    return scatter_nd_add(zeros(shape_to_tuple(shape), dtype=updates.dtype),
                          index, updates)


dispatch.register_op("where", lambda c, x, y: torch.where(
    c if c.dtype == torch.bool else c != 0, x, y))


def where(condition, x=None, y=None, name=None):
    condition = as_tensor(condition)
    if x is None and y is None:
        return tuple(Tensor._wrap(i) for i in torch.nonzero(
            condition._data, as_tuple=True))
    x, y = prep_binary(x, y)
    return dispatch.apply("where", [condition, x, y])


def where_(condition, x, y, name=None):
    out = where(condition, x, y)
    if isinstance(x, Tensor):
        x._data = out._data
        return x
    return out


dispatch.register_op("select_scatter", lambda x, v, *, axis, index:
                     torch.select_scatter(x, v, axis, index))


def select_scatter(x, values, axis, index, name=None):
    x = as_tensor(x)
    ax = normalize_axis(axis, x.ndim)
    return dispatch.apply("select_scatter", [x, cast(as_tensor(values),
                                                     x.dtype)],
                          {"axis": ax, "index": int(index) % x.shape[ax]})


# -- sort / search -----------------------------------------------------------
def _topk(x, *, k, axis, largest, sorted):
    # a stable sort: ties keep the lower index first, as lax.top_k does
    idx = torch.sort(x, dim=axis, descending=largest, stable=True).indices
    idx = idx.narrow(axis, 0, k)
    return torch.gather(x, axis, idx), idx


dispatch.register_op("topk", _topk, multi_out=True)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    x = as_tensor(x)
    if isinstance(k, Tensor):
        k = int(k.item())
    ax = normalize_axis(axis if axis is not None else -1, x.ndim)
    return tuple(dispatch.apply("topk", [x], {
        "k": int(k), "axis": ax, "largest": bool(largest),
        "sorted": bool(sorted)}))


dispatch.register_op("sort_op", lambda x, *, axis, desc: torch.sort(
    x, dim=axis, descending=desc, stable=True).values)
dispatch.register_op("argsort_op", lambda x, *, axis, desc: torch.sort(
    x, dim=axis, descending=desc, stable=True).indices)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    x = as_tensor(x)
    return dispatch.apply("sort_op", [x], {
        "axis": normalize_axis(axis, x.ndim), "desc": bool(descending)})


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    x = as_tensor(x)
    return dispatch.apply("argsort_op", [x], {
        "axis": normalize_axis(axis, x.ndim), "desc": bool(descending)})


dispatch.register_op("searchsorted", lambda a, v, *, right: torch.searchsorted(
    a, v, right=right))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    out = dispatch.apply("searchsorted", [as_tensor(sorted_sequence),
                                          as_tensor(values)],
                         {"right": bool(right)})
    return cast(out, "int32") if out_int32 else out


# jnp.digitize(x, b, right=not right) is searchsorted(b, x) on `right`'s
# side
dispatch.register_op("bucketize", lambda x, b, *, right: torch.searchsorted(
    b, x, right=right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    out = dispatch.apply("bucketize", [as_tensor(x),
                                       as_tensor(sorted_sequence)],
                         {"right": bool(right)})
    return cast(out, "int32") if out_int32 else out


# -- dynamic shapes: the values are read on the host ------------------------
def _host_tensor(arr, like):
    return Tensor._wrap(torch.as_tensor(np.ascontiguousarray(arr),
                                        device=like._data.device))


def nonzero(x, as_tuple=False):
    x = as_tensor(x)
    idx = np.nonzero(x.numpy())
    if as_tuple:
        return tuple(_host_tensor(i.astype(np.int64), x) for i in idx)
    return _host_tensor(np.stack(idx, axis=1).astype(np.int64), x)


def masked_select(x, mask, name=None):
    """The values of x where `mask` (x's size) holds, in order: the mask
    is read on the host and the values gathered on x's device, so the
    gradient flows to x."""
    x, mask = as_tensor(x), as_tensor(mask)
    flat_idx = np.nonzero(mask.numpy().astype(bool).reshape(-1))[0]
    return gather(reshape(x, [-1]), _host_tensor(flat_idx.astype(np.int64),
                                                 x))


def masked_fill(x, mask, value, name=None):
    x, mask = as_tensor(x), as_tensor(mask)
    if isinstance(value, Tensor):
        v = cast(value, x.dtype)
    else:
        v = as_tensor(value, dtype=x.dtype, device=x._data.device)
    vb = broadcast_to(v, x.shape) if v.size == 1 else v
    return where(mask, vb, x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    x = as_tensor(x)
    res = np.unique(x.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not (return_index or return_inverse or return_counts):
        return _host_tensor(res, x)
    return tuple(_host_tensor(r, x) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = as_tensor(x)
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    arr = x.numpy().reshape(-1)
    change = np.concatenate([[True], arr[1:] != arr[:-1]])
    outs = [_host_tensor(arr[change], x)]
    if return_inverse:
        outs.append(_host_tensor((np.cumsum(change) - 1).astype(np.int64),
                                 x))
    if return_counts:
        idx = np.nonzero(change)[0]
        outs.append(_host_tensor(np.diff(np.concatenate(
            [idx, [len(arr)]])).astype(np.int64), x))
    return outs[0] if len(outs) == 1 else tuple(outs)


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


def slice(input, axes, starts, ends):
    input = as_tensor(input)
    idx = [builtins.slice(None)] * input.ndim
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(int(st), int(en))
    return getitem(input, tuple(idx))


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = as_tensor(x)
    idx = [builtins.slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = builtins.slice(int(st), int(en), int(sd))
    return getitem(x, tuple(idx))


def crop(x, shape=None, offsets=None, name=None):
    x = as_tensor(x)
    shape = shape_to_tuple(shape)
    offsets = shape_to_tuple(offsets) if offsets is not None \
        else (0,) * x.ndim
    return getitem(x, tuple(builtins.slice(o, o + s if s != -1 else None)
                            for o, s in zip(offsets, shape)))


# -- shape helpers and the rest ----------------------------------------------
def _int64(v, like):
    return Tensor._wrap(torch.tensor(v, dtype=torch.int64,
                                     device=like._data.device))


def shape(x):
    x = as_tensor(x)
    return _int64(list(x._data.shape), x)


def numel(x, name=None):
    x = as_tensor(x)
    return _int64(x.size, x)


def rank(x):
    x = as_tensor(x)
    return _int64(x.ndim, x)


dispatch.register_op("as_complex", lambda x: torch.complex(x[..., 0],
                                                           x[..., 1]))
dispatch.register_op("as_real", lambda x: torch.stack(
    [torch.real(x), torch.imag(x)], dim=-1))


def as_complex(x, name=None):
    return dispatch.apply("as_complex", [as_tensor(x)])


def as_real(x, name=None):
    return dispatch.apply("as_real", [as_tensor(x)])


dispatch.register_op("one_hot", lambda x, *, n: torch.nn.functional.one_hot(
    x.long(), n).to(torch.float32))


def one_hot(x, num_classes, name=None):
    return dispatch.apply("one_hot", [as_tensor(x)], {"n": int(num_classes)})


dispatch.register_op("diagonal", lambda x, *, offset, a1, a2: torch.diagonal(
    x, offset, a1, a2))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    x = as_tensor(x)
    return dispatch.apply("diagonal", [x], {
        "offset": int(offset), "a1": normalize_axis(axis1, x.ndim),
        "a2": normalize_axis(axis2, x.ndim)})


dispatch.register_op("diag_embed", lambda x, *, offset, dim1, dim2:
                     torch.diag_embed(x, offset, dim1, dim2))


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return dispatch.apply("diag_embed", [as_tensor(x)], {
        "offset": int(offset), "dim1": int(dim1), "dim2": int(dim2)})
