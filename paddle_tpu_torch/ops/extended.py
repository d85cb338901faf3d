"""The port of `paddle_tpu/ops/extended.py`: the stack and split families,
windowed and strided views, the scatter-by-index family, running
extremes and searches, the special functions, pairwise distances, the
seeded draws, the host helpers (`finfo`, `iinfo`, `tolist`, ...) and the
in-place table (`_INPLACE`).

Semantics are the JAX package's, op by op:
- Gathers and scatters keep the port's index rule: a negative index
  wraps once, as in JAX; an index still out of range raises on the CPU
  (a device assert on the card) where JAX clamps a gather or drops a
  scatter. `take(mode="wrap")` and `take(mode="clip")` follow JAX's
  arithmetic (`mode="raise"` raises; JAX clips it under jit).
- `cummax` / `cummin` give the index of the LAST tied extreme, as the
  JAX package's associative-scan `combine` does; `kthvalue` and `mode`
  break ties through a stable sort, as JAX does.
- `cdist` is JAX's formula (the matmul expansion for p = 2), not
  `torch.cdist`'s.
- The seeded draws take their key from the default generator
  (`framework/random.py`, JAX's threefry stream): `cauchy_`,
  `exponential_`, `geometric_`, `bernoulli_`, `uniform_` and
  `randint_like` transform `jax.random.uniform` / `randint` bits as
  `jax.random` does; `standard_gamma` (Marsaglia-Tsang), `poisson` (Knuth
  below lambda 10, Hormann's transformed rejection above) and `binomial`
  (inversion below n p 10, BTRS above) run `jax.random`'s loops as
  written, on the same keys, vectorised over the elements.
"""
from __future__ import annotations

import builtins
import itertools
import math as _pymath

import numpy as np
import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ..framework.place import expected_device
from ..ops.sampling import threefry2x32
from ._helpers import (as_tensor, inplace_rebind, make_binary,
                       make_float_unary, normalize_axis, prep_binary,
                       result_dtype)


def _reg(name, fn, multi_out=False):
    if name not in dispatch.op_registry():
        dispatch.register_op(name, fn, multi_out=multi_out)


def _common(ts):
    """Tensors cast to their promoted dtype (as the jnp functions
    promote)."""
    from .manipulation import cast

    d = ts[0]._data.dtype
    for t in ts[1:]:
        d = result_dtype(d, t._data.dtype)
    return [cast(t, d) for t in ts]


# ---------------------------------------------------------------------------
# stacking / splitting
# ---------------------------------------------------------------------------

def _stack_family(name, tfn):
    _reg(name, lambda *xs: tfn(xs))

    def api(x, name_=None):
        return dispatch.apply(name, _common([as_tensor(t) for t in x]))

    api.__name__ = name
    return api


hstack = _stack_family("hstack", torch.hstack)
vstack = _stack_family("vstack", torch.vstack)
dstack = _stack_family("dstack", torch.dstack)
column_stack = _stack_family("column_stack", torch.column_stack)
row_stack = vstack


def tensor_split(x, num_or_indices, axis=0, name=None):
    """`split` that allows uneven sections (the first `dim % n` one
    longer), or split points."""
    from .manipulation import split

    x = as_tensor(x)
    axis = normalize_axis(axis, x.ndim)
    dim = x._data.shape[axis]
    if isinstance(num_or_indices, int):
        base, rem = divmod(dim, num_or_indices)
        sections = [base + 1] * rem + [base] * (num_or_indices - rem)
    else:
        bounds = [0] + [int(p) for p in num_or_indices] + [dim]
        sections = [builtins.max(0, bounds[i + 1] - bounds[i])
                    for i in range(len(bounds) - 1)]
    return split(x, sections, axis=axis)


def _split_family(name, axis_of):
    def api(x, num_or_indices=None, name_=None):
        x = as_tensor(x)
        return tensor_split(x, num_or_indices, axis=axis_of(x))

    api.__name__ = name
    return api


hsplit = _split_family("hsplit", lambda x: 0 if x.ndim == 1 else 1)
vsplit = _split_family("vsplit", lambda x: 0)
dsplit = _split_family("dsplit", lambda x: 2)


def _atleast(fn, opname):
    _reg(opname, fn)

    def api(*inputs, name=None):
        outs = [dispatch.apply(opname, [as_tensor(t)]) for t in inputs]
        return outs if len(outs) > 1 else outs[0]

    api.__name__ = opname
    return api


atleast_1d = _atleast(torch.atleast_1d, "atleast_1d")
atleast_2d = _atleast(torch.atleast_2d, "atleast_2d")
atleast_3d = _atleast(torch.atleast_3d, "atleast_3d")

_reg("block_diag", lambda *xs: torch.block_diag(*xs))


def block_diag(inputs, name=None):
    return dispatch.apply("block_diag", _common([as_tensor(t)
                                                 for t in inputs]))


def unflatten(x, axis, shape, name=None):
    from .manipulation import reshape

    x = as_tensor(x)
    axis = normalize_axis(axis, x.ndim)
    shape = tuple(int(s) for s in shape)
    return reshape(x, tuple(x.shape[:axis]) + shape
                   + tuple(x.shape[axis + 1:]))


_reg("unfold_axis", lambda x, *, axis, size, step: x.unfold(axis, size,
                                                            step))


def unfold(x, axis, size, step, name=None):
    """Windows of `size` every `step` along `axis`, the window axis
    appended last."""
    x = as_tensor(x)
    axis = normalize_axis(axis, x.ndim)
    dim = x._data.shape[axis]
    if step <= 0:
        raise ValueError(f"unfold: step must be positive, got {step}")
    if size <= 0 or size > dim:
        raise ValueError(f"unfold: size ({size}) must be in [1, {dim}] for "
                         f"dim {axis}")
    return dispatch.apply("unfold_axis", [x], {"axis": axis,
                                               "size": int(size),
                                               "step": int(step)})


_reg("bitcast_view", lambda x, *, dtype: x.contiguous().view(dtype))


def view(x, shape_or_dtype, name=None):
    """A shape (`reshape`) or a dtype: the same bytes read as `dtype`,
    the last axis scaled by the itemsize ratio."""
    from .manipulation import reshape

    x = as_tensor(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return dispatch.apply("bitcast_view", [x], {
        "dtype": dtype_mod.to_torch(shape_or_dtype)})


def view_as(x, other, name=None):
    from .manipulation import reshape

    return reshape(as_tensor(x), tuple(as_tensor(other).shape))


_reg("as_strided_view", lambda x, *, shape, stride, offset: torch.as_strided(
    x.contiguous().reshape(-1), shape, stride, offset))


def as_strided(x, shape, stride, offset=0, name=None):
    """A strided read of the contiguous buffer (an element past its end
    raises)."""
    x = as_tensor(x)
    shape = tuple(int(s) for s in shape)
    stride = tuple(int(s) for s in stride)
    last = int(offset) + builtins.sum((s - 1) * st
                                      for s, st in zip(shape, stride))
    if builtins.min(shape, default=1) > 0 and \
            not 0 <= last < builtins.max(x.size, 1) or offset < 0:
        raise IndexError(f"as_strided: element {last} outside the "
                         f"{x.size} elements of the input")
    return dispatch.apply("as_strided_view", [x], {
        "shape": shape, "stride": stride, "offset": int(offset)})


def reverse(x, axis, name=None):
    from .manipulation import flip

    return flip(x, axis)


def _take(x, i, *, mode):
    flat = x.reshape(-1)
    n = flat.shape[0]
    if mode == "wrap":
        i = torch.remainder(i, n)
    else:
        i = torch.where(i < 0, i + n, i)
        if mode == "clip":
            i = i.clamp(0, n - 1)
    return torch.index_select(flat, 0, i.reshape(-1)).reshape(i.shape)


_reg("take_flat", _take)


def take(x, index, mode="raise", name=None):
    """Elements of the flattened `x`: `"wrap"` takes the index modulo the
    size; `"clip"` wraps a negative index once and clamps; `"raise"`
    wraps a negative index once and raises on one still out of range."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(f"take: mode must be 'raise', 'wrap' or 'clip', "
                         f"got {mode!r}")
    x = as_tensor(x)
    return dispatch.apply("take_flat", [
        x, as_tensor(index, device=x._data.device)], {"mode": str(mode)})


_reg("trace_op", lambda x, *, offset, axis1, axis2: torch.diagonal(
    x, offset, axis1, axis2).sum(-1))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return dispatch.apply("trace_op", [as_tensor(x)], {
        "offset": int(offset), "axis1": int(axis1), "axis2": int(axis2)})


def _vander(x, *, n, increasing):
    p = torch.arange(n, device=x.device)
    if not increasing:
        p = p.flip(0)
    if n == 0:
        return x[:, None][:, :0]
    return x[:, None] ** p.to(x.dtype if x.dtype.is_floating_point
                              or x.dtype.is_complex else torch.int64)


_reg("vander_op", _vander)


def vander(x, n=None, increasing=False, name=None):
    x = as_tensor(x)
    n = int(n) if n is not None else x._data.shape[0]
    return dispatch.apply("vander_op", [x], {"n": n,
                                             "increasing": bool(increasing)})


def _index_pairs(fn, row, col, offset, dtype):
    col = row if col is None else col
    r, c = fn(int(row), int(offset), int(col))
    return Tensor(np.stack([r, c]).astype(dtype_mod.convert_dtype(
        dtype).np_dtype))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    return _index_pairs(np.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _index_pairs(np.triu_indices, row, col, offset, dtype)


def _cartesian(*xs):
    grids = torch.meshgrid(*xs, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


_reg("cartesian_prod", _cartesian)


def cartesian_prod(x, name=None):
    return dispatch.apply("cartesian_prod", _common([as_tensor(t)
                                                     for t in x]))


_reg("combinations_gather", lambda x, i: torch.index_select(
    x, 0, i.reshape(-1)).reshape(i.shape))


def combinations(x, r=2, with_replacement=False, name=None):
    x = as_tensor(x)
    combo = (itertools.combinations_with_replacement if with_replacement
             else itertools.combinations)
    idx = np.array(list(combo(range(x._data.shape[0]), r)),
                   dtype=np.int64).reshape(-1, r)
    return dispatch.apply("combinations_gather", [x, Tensor(
        idx, place=x._data.device)])


# ---------------------------------------------------------------------------
# scatter-by-index
# ---------------------------------------------------------------------------

def _wrap_neg(i, n):
    return torch.where(i < 0, i + n, i)


def _index_add(x, i, v, *, axis):
    i = _wrap_neg(i.reshape(-1), x.shape[axis])
    shape = list(x.shape)
    shape[axis] = i.shape[0]
    return x.index_add(axis, i, torch.broadcast_to(v.to(x.dtype), shape))


_reg("index_add_op", _index_add)


def index_add(x, index, axis, value, name=None):
    x = as_tensor(x)
    return dispatch.apply("index_add_op", [
        x, as_tensor(index, device=x._data.device), as_tensor(value)],
        {"axis": normalize_axis(axis, x.ndim)})


_reg("index_fill_op", lambda x, i, *, axis, value: x.index_fill(
    axis, _wrap_neg(i.reshape(-1), x.shape[axis]), value))


def index_fill(x, index, axis, value, name=None):
    x = as_tensor(x)
    if isinstance(value, Tensor):
        value = float(np.asarray(value.numpy()))
    return dispatch.apply("index_fill_op", [
        x, as_tensor(index, device=x._data.device)], {
        "axis": normalize_axis(axis, x.ndim), "value": float(value)})


def _index_put(x, v, *ii, accumulate):
    return x.index_put(tuple(ii), v.to(x.dtype), accumulate=accumulate)


_reg("index_put_op", _index_put)


def index_put(x, indices, value, accumulate=False, name=None):
    x = as_tensor(x)
    dev = x._data.device
    return dispatch.apply("index_put_op", [x, as_tensor(value)]
                          + [as_tensor(i, device=dev) for i in indices],
                          {"accumulate": bool(accumulate)})


def _masked_scatter(x, m, v):
    m = torch.broadcast_to(m, x.shape)
    need = int(m.sum()) if m.device.type == "cpu" else 0
    if need > v.numel():
        raise IndexError(f"masked_scatter: {need} masked positions, "
                         f"{v.numel()} values")
    return x.masked_scatter(m, v.to(x.dtype))


_reg("masked_scatter_op", _masked_scatter)


def masked_scatter(x, mask, value, name=None):
    """The True positions of `mask` take `value`'s elements in order;
    fewer values than positions raise (JAX repeats the last)."""
    x = as_tensor(x)
    return dispatch.apply("masked_scatter_op", [
        x, as_tensor(mask, device=x._data.device), as_tensor(value)])


def _slice_scatter(x, v, *, axes, starts, ends, strides):
    sl = [builtins.slice(None)] * x.dim()
    for a, s, e, st in zip(axes, starts, ends, strides):
        sl[a] = builtins.slice(s, e, st)
    out = x.clone()
    out[tuple(sl)] = v.to(x.dtype)
    return out


_reg("slice_scatter_op", _slice_scatter)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    x = as_tensor(x)
    return dispatch.apply("slice_scatter_op", [x, as_tensor(value)], {
        "axes": tuple(normalize_axis(a, x.ndim) for a in axes),
        "starts": tuple(int(s) for s in starts),
        "ends": tuple(int(e) for e in ends),
        "strides": tuple(int(s) for s in strides)})


_reg("diagonal_scatter_op", lambda x, y, *, offset, axis1, axis2:
     torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2))


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return dispatch.apply("diagonal_scatter_op", [as_tensor(x), as_tensor(y)],
                          {"offset": int(offset), "axis1": int(axis1),
                           "axis2": int(axis2)})


def _multiplex(i, *xs):
    stacked = torch.stack(xs)
    b = stacked.shape[1]
    sel = i.reshape(-1)[:b].to(torch.int64)
    return stacked[sel, torch.arange(b, device=stacked.device)]


_reg("multiplex", _multiplex)


def multiplex(inputs, index, name=None):
    ts = [as_tensor(t) for t in inputs]
    return dispatch.apply("multiplex", [as_tensor(
        index, device=ts[0]._data.device)] + ts)


def _shard_index(x, *, index_num, nshards, shard_id, ignore_value):
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(x, size, rounding_mode="floor") == shard_id,
                       torch.remainder(x, size),
                       torch.full((), ignore_value, dtype=x.dtype,
                                  device=x.device))


_reg("shard_index_op", _shard_index)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    return dispatch.apply("shard_index_op", [as_tensor(input)], {
        "index_num": int(index_num), "nshards": int(nshards),
        "shard_id": int(shard_id), "ignore_value": int(ignore_value)})


def increment(x, value=1.0, name=None):
    from .math import add

    return inplace_rebind(x, add(x, value))


def _reduce_as(x, *, tgt):
    lead = x.dim() - len(tgt)
    axes = tuple(range(lead)) + tuple(
        lead + i for i, (xs, ts) in enumerate(zip(x.shape[lead:], tgt))
        if ts == 1 and xs != 1)
    out = x.sum(dim=axes) if axes else x
    return out.reshape(tgt)


_reg("reduce_as_op", _reduce_as)


def reduce_as(x, target, name=None):
    """Sum `x` down to `target`'s shape."""
    return dispatch.apply("reduce_as_op", [as_tensor(x)], {
        "tgt": tuple(as_tensor(target).shape)})


# ---------------------------------------------------------------------------
# running extremes and searches
# ---------------------------------------------------------------------------

def _cum_extreme(x, *, axis, dtype, is_max):
    if axis is None:
        x, axis = x.reshape(-1), 0
    # torch's cummax / cummin take the later index of a tie, as JAX's
    # combine (`b >= a` keeps b)
    v, i = (torch.cummax if is_max else torch.cummin)(x, axis)
    return v, i.to(dtype)


_reg("cummax_op", lambda x, *, axis, dtype: _cum_extreme(
    x, axis=axis, dtype=dtype, is_max=True), multi_out=True)
_reg("cummin_op", lambda x, *, axis, dtype: _cum_extreme(
    x, axis=axis, dtype=dtype, is_max=False), multi_out=True)


def _cum_api(opname):
    def api(x, axis=None, dtype="int64", name=None):
        x = as_tensor(x)
        return tuple(dispatch.apply(opname, [x], {
            "axis": None if axis is None else normalize_axis(axis, x.ndim),
            "dtype": dtype_mod.to_torch(dtype)}))

    api.__name__ = opname[:-3]
    return api


cummax = _cum_api("cummax_op")
cummin = _cum_api("cummin_op")


def _kthvalue(x, *, k, axis, keepdim):
    sv, si = torch.sort(x, dim=axis, stable=True)
    v = sv.narrow(axis, k - 1, 1)
    i = si.narrow(axis, k - 1, 1)
    if not keepdim:
        v, i = v.squeeze(axis), i.squeeze(axis)
    return v, i.to(torch.int64)


_reg("kthvalue_op", _kthvalue, multi_out=True)


def kthvalue(x, k, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    axis = normalize_axis(x.ndim - 1 if axis is None else axis, x.ndim)
    return tuple(dispatch.apply("kthvalue_op", [x], {
        "k": int(k), "axis": axis, "keepdim": bool(keepdim)}))


def _mode(x, *, axis, keepdim):
    # a stable sort, then each run's extent by a running max / min of the
    # run-boundary markers; the first longest run (the smallest mode) and
    # its LAST element's original index, as the JAX package's
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    sv, si = torch.sort(xm, dim=-1, stable=True)
    bidx = torch.arange(n, device=x.device).expand(sv.shape)
    ones = torch.ones_like(sv[..., :1], dtype=torch.bool)
    start_mark = torch.cat([ones, sv[..., 1:] != sv[..., :-1]], dim=-1)
    end_mark = torch.cat([start_mark[..., 1:], ones], dim=-1)
    start = torch.cummax(torch.where(start_mark, bidx, 0), -1).values
    end = torch.cummin(torch.where(end_mark, bidx, n - 1).flip(-1),
                       -1).values.flip(-1)
    pos = torch.argmax(end - start + 1, dim=-1, keepdim=True)
    val = torch.gather(sv, -1, pos)[..., 0]
    idx = torch.gather(si, -1, torch.gather(end, -1, pos))[..., 0]
    if keepdim:
        val, idx = val.unsqueeze(axis), idx.unsqueeze(axis)
    return val, idx.to(torch.int64)


_reg("mode_op", _mode, multi_out=True)


def mode(x, axis=-1, keepdim=False, name=None):
    x = as_tensor(x)
    return tuple(dispatch.apply("mode_op", [x], {
        "axis": normalize_axis(axis, x.ndim), "keepdim": bool(keepdim)}))


_reg("isin_op", lambda x, t, *, invert: torch.isin(x, t, invert=invert))


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    x = as_tensor(x)
    return dispatch.apply("isin_op", [
        x, as_tensor(test_x, device=x._data.device)], {"invert": bool(invert)})


def _linspace(lo, hi, num, dtype, device):
    """`jnp.linspace(lo, hi, num)`: lo * (1 - i / (num - 1)) + hi * i /
    (num - 1), the last point exactly hi."""
    lo = torch.as_tensor(lo, dtype=dtype, device=device).reshape(1)
    hi = torch.as_tensor(hi, dtype=dtype, device=device).reshape(1)
    if num <= 1:
        return lo[:num]
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    return torch.cat([lo * (1 - step) + hi * step, hi])


def _bin_edges(x, *, bins, min, max):
    if min != 0 or max != 0:
        # Python floats: the x64 default float
        return _linspace(min, max, bins + 1, torch.float64, x.device)
    lo, hi = x.min(), x.max()
    hi = torch.where(hi == lo, lo + 1.0, hi)
    return _linspace(lo, hi, bins + 1, x.dtype, x.device)


_reg("histogram_bin_edges_op", _bin_edges)


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    return dispatch.apply("histogram_bin_edges_op", [as_tensor(input)],
                          {"bins": int(bins), "min": float(min),
                           "max": float(max)})


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """`np.histogramdd` on the host (as the JAX package computes it); the
    float64 counts and edges go to x's device."""
    x = as_tensor(x)
    dev = x._data.device
    w = np.asarray(as_tensor(weights).numpy()) if weights is not None \
        else None
    if isinstance(bins, (list, tuple)) and len(bins) \
            and isinstance(bins[0], Tensor):
        bins = [np.asarray(b.numpy()) for b in bins]
    hist, edges = np.histogramdd(np.asarray(x.numpy()), bins=bins,
                                 range=ranges, density=density, weights=w)
    return (Tensor(hist, place=dev),
            [Tensor(e, place=dev) for e in edges])


# ---------------------------------------------------------------------------
# special functions
# ---------------------------------------------------------------------------

def _logit(x, *, eps):
    if eps is not None:
        x = x.clamp(eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


_reg("logit_op", _logit)


def logit(x, eps=None, name=None):
    return dispatch.apply("logit_op", [as_tensor(x)], {
        "eps": float(eps) if eps is not None else None})


sinc = make_float_unary("sinc", torch.sinc)
gammaln = make_float_unary("gammaln", torch.special.gammaln)
i0e = make_float_unary("i0e", torch.special.i0e)
i1e = make_float_unary("i1e", torch.special.i1e)
gammainc = make_binary("gammainc", torch.special.gammainc, float_only=True)
gammaincc = make_binary("gammaincc", torch.special.gammaincc,
                        float_only=True)
ldexp = make_binary("ldexp", lambda x, e: x * torch.exp2(e.to(x.dtype)),
                    float_only=True)


def _inexact(x):
    """JAX's `promote_args_inexact` of one array under x64: an integer
    or bool input as float64."""
    return x if dtype_mod.is_inexact(x.dtype) else x.to(torch.float64)


def _multigammaln(a, *, p):
    a = _inexact(a)
    const = 0.25 * p * (p - 1) * _pymath.log(_pymath.pi)
    b = torch.arange(p, dtype=a.dtype, device=a.device) / 2
    return torch.special.gammaln(a[..., None] - b).sum(-1) \
        + torch.tensor(const, dtype=a.dtype, device=a.device)


_reg("multigammaln_op", _multigammaln)


def multigammaln(x, p, name=None):
    return dispatch.apply("multigammaln_op", [as_tensor(x)], {"p": int(p)})


_reg("polygamma_op", lambda x, *, n: torch.special.polygamma(n, _inexact(x)))


def polygamma(x, n, name=None):
    return dispatch.apply("polygamma_op", [as_tensor(x)], {"n": int(n)})


_reg("frexp_op", lambda x: tuple(torch.frexp(x)), multi_out=True)


def frexp(x, name=None):
    m, e = dispatch.apply("frexp_op", [as_tensor(x)])
    return m, e


def _pred(opname, fn):
    _reg(opname, fn)

    def api(x, name=None):
        return dispatch.apply(opname, [as_tensor(x)])

    api.__name__ = opname[:-3]
    return api


signbit = _pred("signbit_op", torch.signbit)
sgn = _pred("sgn_op", torch.sgn)
isneginf = _pred("isneginf_op", torch.isneginf)
isposinf = _pred("isposinf_op", torch.isposinf)
isreal = _pred("isreal_op", torch.isreal)


def is_complex(x):
    return as_tensor(x)._data.dtype.is_complex


def is_floating_point(x):
    return as_tensor(x)._data.dtype.is_floating_point


def is_integer(x):
    d = as_tensor(x)._data.dtype
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


_reg("complex_op", torch.complex)


def complex(real, imag, name=None):
    return dispatch.apply("complex_op", list(prep_binary(real, imag)))


_reg("polar_op", lambda a, t: torch.complex(a * torch.cos(t),
                                            a * torch.sin(t)))


def polar(abs, angle, name=None):
    return dispatch.apply("polar_op", list(prep_binary(abs, angle)))


def _renorm(x, *, p, axis, max_norm):
    red = tuple(d for d in range(x.dim()) if d != axis)
    norms = (x.abs() ** p).sum(dim=red, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


_reg("renorm_op", _renorm)


def renorm(x, p, axis, max_norm, name=None):
    x = as_tensor(x)
    return dispatch.apply("renorm_op", [x], {
        "p": float(p), "axis": normalize_axis(axis, x.ndim),
        "max_norm": float(max_norm)})


def _trapezoid_x(y, x, *, axis):
    y = torch.movedim(_inexact(y), axis, -1)
    x = _inexact(x)
    d = torch.diff(torch.movedim(x, axis, -1) if x.dim() == y.dim() else x,
                   dim=-1)
    return 0.5 * (d * (y[..., 1:] + y[..., :-1])).sum(-1)


def _trapezoid_dx(y, *, dx, axis):
    y = torch.movedim(_inexact(y), axis, -1)
    return 0.5 * (dx * (y[..., 1:] + y[..., :-1])).sum(-1)


_reg("trapezoid_x", _trapezoid_x)
_reg("trapezoid_dx", _trapezoid_dx)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = as_tensor(y)
    if x is not None:
        return dispatch.apply("trapezoid_x", [y, as_tensor(x)],
                              {"axis": int(axis)})
    return dispatch.apply("trapezoid_dx", [y], {
        "dx": float(dx if dx is not None else 1.0), "axis": int(axis)})


def _cum_trapezoid_dx(y, *, dx, axis):
    ym = torch.movedim(y, axis, -1)
    avg = (ym[..., 1:] + ym[..., :-1]) * 0.5 * dx
    return torch.movedim(torch.cumsum(avg, -1), -1, axis)


def _cum_trapezoid_x(y, x, *, axis):
    ym = torch.movedim(y, axis, -1)
    if x.dim() == y.dim():
        xm = torch.movedim(torch.broadcast_to(x, y.shape), axis, -1)
    else:
        xm = torch.movedim(x, 0, -1)
    avg = (ym[..., 1:] + ym[..., :-1]) * 0.5 * torch.diff(xm, dim=-1)
    return torch.movedim(torch.cumsum(avg, -1), -1, axis)


_reg("cumulative_trapezoid_dx", _cum_trapezoid_dx)
_reg("cumulative_trapezoid_x", _cum_trapezoid_x)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = as_tensor(y)
    if x is not None:
        return dispatch.apply("cumulative_trapezoid_x", [y, as_tensor(x)],
                              {"axis": int(axis)})
    return dispatch.apply("cumulative_trapezoid_dx", [y], {
        "dx": float(dx if dx is not None else 1.0), "axis": int(axis)})


def _cdist(x, y, *, p):
    if p == 2.0:
        x2 = (x * x).sum(-1, keepdim=True)
        y2 = (y * y).sum(-1, keepdim=True)
        xy = torch.matmul(x, y.transpose(-1, -2))
        return torch.sqrt(torch.clamp(x2 - 2.0 * xy + y2.transpose(-1, -2),
                                      min=0.0))
    diff = (x[..., :, None, :] - y[..., None, :, :]).abs()
    if p == 0:
        return (diff != 0).to(x.dtype).sum(-1)
    if _pymath.isinf(p):
        return diff.amax(-1)
    return (diff ** p).sum(-1) ** (1.0 / p)


_reg("cdist_op", _cdist)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-distances [..., P, R] by the JAX package's formula (p 2
    by the matmul expansion, clamped at 0)."""
    return dispatch.apply("cdist_op", list(prep_binary(x, y)),
                          {"p": float(p)})


_reg("pdist_gather", lambda d, r, c: d[r, c])


def pdist(x, p=2.0, name=None):
    x = as_tensor(x)
    n = x._data.shape[0]
    r, c = np.triu_indices(n, 1)
    dev = x._data.device
    return dispatch.apply("pdist_gather", [cdist(x, x, p=p),
                                           Tensor(r, place=dev),
                                           Tensor(c, place=dev)])


def _nanquantile(x, *, qs, axis, keepdim, method):
    q = torch.tensor(qs, dtype=x.dtype, device=x.device)
    out = torch.nanquantile(x, q, dim=axis, keepdim=keepdim,
                            interpolation=method)
    return out if len(qs) > 1 else out[0]


_reg("nanquantile_op", _nanquantile)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    x = as_tensor(x)
    qs = tuple(float(v) for v in (q if isinstance(q, (list, tuple))
                                  else [q]))
    return dispatch.apply("nanquantile_op", [x], {
        "qs": qs, "axis": normalize_axis(axis, x.ndim),
        "keepdim": bool(keepdim), "method": str(interpolation)})


_reg("tensordot", lambda x, y, *, axes: torch.tensordot(x, y, dims=axes))


def tensordot(x, y, axes=2, name=None):
    x, y = prep_binary(x, y)
    if isinstance(axes, int):
        key = int(axes)
    else:
        a, b = axes
        key = ([a] if isinstance(a, int) else [int(v) for v in a],
               [b] if isinstance(b, int) else [int(v) for v in b])
    return dispatch.apply("tensordot", [x, y], {"axes": key})


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    """`base ** linspace(start, stop, num)` in float64, then cast."""
    d = dtype_mod.to_torch(dtype) if dtype is not None \
        else dtype_mod.get_default_dtype().torch_dtype
    lin = _linspace(float(start), float(stop), int(num), torch.float64,
                    expected_device())
    return Tensor._wrap(torch.pow(torch.tensor(float(base),
                                               dtype=torch.float64,
                                               device=lin.device),
                                  lin).to(d))


# ---------------------------------------------------------------------------
# seeded draws (`jax.random`'s transforms and loops on the port's keys)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _key_tensor(device=None) -> Tensor:
    return Tensor._wrap(torch.tensor(random_mod.next_key(), dtype=torch.int64,
                                     device=expected_device(device)))


def _split_keys(k, n):
    """`jax.random.split(k, n)` of a batch of keys ([..., 2] int64 words)
    -> [..., n, 2]."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    a, b = threefry2x32(k[..., 0:1], k[..., 1:2], torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def _scalar_uniform(k, dtype, lo=0.0, hi=1.0):
    """`jax.random.uniform(k, (), dtype, lo, hi)` of each key of a batch
    [..., 2], rounded as `framework/random.uniform` rounds it."""
    zero = torch.zeros_like(k[..., 0])
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], zero, zero)
    if dtype == torch.float32:
        f = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32) \
            .view(torch.float32) - 1.0
    else:
        f = ((b1 << 20) | (b2 >> 12) | 0x3FF0000000000000) \
            .view(torch.float64) - 1.0
    lo_t = torch.tensor(lo, dtype=dtype, device=k.device)
    scale = (torch.tensor(hi, dtype=dtype, device=k.device) - lo_t).double()
    if dtype == torch.float64:
        y = random_mod._fma64(f, scale.expand_as(f), float(lo_t))
    else:
        y = (f.double() * scale + float(lo_t)).to(dtype)
    return torch.maximum(lo_t, y)


def _scalar_normal(k, dtype):
    """`jax.random.normal(k, (), dtype)` of each key of a batch."""
    np_t = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    lo = float(np.nextafter(np_t(-1.0), np_t(0.0)))
    return torch.tensor(np.sqrt(2), dtype=dtype, device=k.device) \
        * random_mod.erf_inv(_scalar_uniform(k, dtype, lo, 1.0))


def _gamma_one(keys, alpha):
    """`jax.random._gamma_one` (Marsaglia-Tsang, not in log space) for a
    batch of keys [N, 2] and alphas [N], the while loops run as masked
    loops over the batch."""
    dt = alpha.dtype
    one = torch.ones((), dtype=dt, device=alpha.device)
    boost_mask = alpha >= one
    alpha_orig = alpha
    alpha = torch.where(boost_mask, alpha, alpha + one)
    d = alpha - 1.0 / 3.0
    c = (1.0 / 3.0) / torch.sqrt(d)
    sk = _split_keys(keys, 2)
    key, subkey = sk[:, 0], sk[:, 1]
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)

    def cond(X, V, U):
        # the logs only where the squeeze test fails, as few draws do
        out = U >= one - 0.0331 * (X * X)
        m = out.nonzero(as_tuple=True)
        out[m] = random_mod.xla_log(U[m]) >= X[m] * 0.5 \
            + d[m] * (one - V[m] + random_mod.xla_log(V[m]))
        return out

    live = cond(X, V, U)
    while bool(live.any()):
        ks = _split_keys(key, 3)
        nkey, x_key, u_key = ks[:, 0], ks[:, 1], ks[:, 2]
        # the inner loop: draw x until v = 1 + x c > 0
        kk = x_key
        x = torch.zeros_like(alpha)
        v = torch.full_like(alpha, -1.0)
        inner = v <= 0
        while bool(inner.any()):
            s = _split_keys(kk, 2)
            kk2, sub = s[:, 0], s[:, 1]
            xn = _scalar_normal(sub, dt)
            vn = random_mod._fma(xn, c, one)
            kk = torch.where(inner[:, None], kk2, kk)
            x = torch.where(inner, xn, x)
            v = torch.where(inner, vn, v)
            inner = v <= 0
        Xn, Vn = x * x, v * v * v
        Un = _scalar_uniform(u_key, dt)
        key = torch.where(live[:, None], nkey, key)
        X = torch.where(live, Xn, X)
        V = torch.where(live, Vn, V)
        U = torch.where(live, Un, U)
        live = cond(X, V, U)
    samples = 1 - _scalar_uniform(subkey, dt)
    boost = torch.where(boost_mask, one, samples ** (one / alpha_orig))
    return d * V * boost


def _standard_gamma(key, a):
    # `jax.random.gamma(key, a)`: float64 (the x64 default) whatever a's
    # dtype, one split key per element
    a = a.to(torch.float64)
    n = a.numel()
    if not n:
        return a
    keys = _split_keys(key[None, :], n)[0]
    return _gamma_one(keys, a.reshape(-1)).reshape(a.shape)


_reg("standard_gamma_op", _standard_gamma)


def standard_gamma(x, name=None):
    x = as_tensor(x)
    return dispatch.apply("standard_gamma_op", [_key_tensor(x._data.device),
                                                x])


def _uniform_k(k, shape, dtype):
    return random_mod.uniform((k[0], k[1]), shape, dtype, 0.0, 1.0,
                              k.device)


def _split1(k, n):
    """`jax.random.split(k, n)` of one key tensor [2] -> n key tensors."""
    s = _split_keys(k[None, :], n)[0]
    return [s[i] for i in range(n)]


def _poisson_knuth(key, lam, shape, dtype):
    k = torch.zeros(shape, dtype=dtype, device=lam.device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=lam.device)
    while bool((log_prod > -lam).any()):
        key, sub = _split1(key, 2)
        k = torch.where(log_prod > -lam, k + 1, k)
        log_prod = log_prod + torch.log(_uniform_k(sub, shape,
                                                   torch.float32))
    return (k - 1).to(dtype)


def _poisson_rejection(key, lam, shape, dtype):
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1, dtype=lam.dtype, device=lam.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    while bool((~accepted).any()):
        key, s0, s1 = _split1(key, 3)
        u = _uniform_k(s0, shape, lam.dtype) - 0.5
        v = _uniform_k(s1, shape, lam.dtype)
        us = 0.5 - u.abs()
        k = torch.floor((2 * a / us + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(dtype)


def _poisson(key, lam):
    """`jax.random.poisson(key, lam)` (int64 under x64), as lam's
    dtype."""
    shape, dt = tuple(lam.shape), lam.dtype
    lam = lam.to(torch.float32)
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_knuth = torch.where(use_knuth, lam, torch.zeros_like(lam))
    lam_rej = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)
    out = torch.where(use_knuth,
                      _poisson_knuth(key, lam_knuth, shape, torch.int64),
                      _poisson_rejection(key, lam_rej, shape, torch.int64))
    return torch.where(lam == 0, torch.zeros_like(out), out).to(dt)


_reg("poisson_op", _poisson)


def poisson(x, name=None):
    x = as_tensor(x)
    return dispatch.apply("poisson_op", [_key_tensor(x._data.device), x])


_STIRLING = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
             0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
             0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
             0.00833056343336287)


def _stirling_tail(k):
    vals = torch.tensor(_STIRLING, dtype=k.dtype, device=k.device)
    use = k <= 9
    kc = k.clamp(0.0, 9.0)
    kp1sq = (kc + 1) * (kc + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (kc + 1)
    return torch.where(use, vals[torch.floor(kc).to(torch.int32).long()],
                       approx)


def _binomial_inversion(key, count, prob, shape):
    log1mp = torch.log1p(-prob)
    num = torch.zeros(shape, dtype=prob.dtype, device=prob.device)
    gsum = torch.zeros(shape, dtype=prob.dtype, device=prob.device)
    while bool((gsum <= count).any()):
        sub, key = _split1(key, 2)
        num = torch.where(gsum <= count, num + 1, num)
        u = _uniform_k(sub, shape, prob.dtype)
        gsum = gsum + torch.ceil(torch.log(u) / log1mp)
    return num - 1


def _btrs(key, count, prob, shape):
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - 4.2 / b
    r = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * prob)
    k_out = torch.full(shape, -1.0, dtype=prob.dtype, device=prob.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=prob.device)
    while bool((~accepted).any()):
        key, s0, s1 = _split1(key, 3)
        u = _uniform_k(s0, shape, prob.dtype)
        v = _uniform_k(s1, shape, prob.dtype)
        u = u - 0.5
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
              + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
              + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
              + _stirling_tail(m) + _stirling_tail(count - m)
              - _stirling_tail(k) - _stirling_tail(count - k))
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out


def _binomial(key, count, prob):
    """`jax.random.binomial(key, n, p)` at the x64 default float, as
    int64."""
    count, prob = count.to(torch.float64), prob.to(torch.float64)
    shape = tuple(torch.broadcast_shapes(count.shape, prob.shape))
    count, prob = count.expand(shape), prob.expand(shape)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    bad_count = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_nan, q_neg = torch.isnan(q), q < 0.0
    q = torch.where(q_nan | q_neg, torch.full_like(q, 0.01), q)
    use_inv = bad_count | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inv, count, torch.zeros_like(count))
    count_btrs = torch.where(use_inv, torch.full_like(count, 1e4), count)
    q_btrs = torch.where(use_inv, torch.full_like(q, 0.5), q)
    out = torch.where(use_inv, _binomial_inversion(key, count_inv, q, shape),
                      _btrs(key, count_btrs, q_btrs, shape))
    invalid = q_neg | q_nan | bad_count
    out = torch.where(invalid, torch.full_like(out, float("nan")), out)
    out = torch.where(count_inf & ~invalid, torch.full_like(out,
                                                            float("inf")),
                      out)
    out = torch.where(p_lt_half | bad_count | q_nan | count_inf, out,
                      count - out)
    return out.to(torch.int64)


_reg("binomial_op", _binomial)


def binomial(count, prob, name=None):
    count, prob = prep_binary(count, prob)
    return dispatch.apply("binomial_op", [_key_tensor(count._data.device),
                                          count, prob])


def standard_normal(shape, dtype=None, name=None):
    from .creation import randn

    return randn(shape, dtype=dtype)


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    from .creation import normal
    from .math import exp

    return exp(normal(mean=mean, std=std, shape=shape))


def _refill(x, out):
    from .manipulation import cast

    return inplace_rebind(x, cast(out, x.dtype))


def normal_(x, mean=0.0, std=1.0, name=None):
    from .creation import normal

    return _refill(x, normal(mean=mean, std=std, shape=tuple(x.shape)))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    return _refill(x, log_normal(mean=mean, std=std, shape=tuple(x.shape)))


def _draw_dtype(x, allowed=("float32", "float64", "bfloat16")):
    n = x.dtype.name
    return dtype_mod.to_torch(n if n in allowed else "float32")


def _cauchy(key, *, shape, loc, scale, dtype):
    eps = float(torch.finfo(dtype).eps)
    u = random_mod.uniform((key[0], key[1]), shape, dtype, eps, 1.0,
                           key.device)
    pi = torch.tensor(np.pi, dtype=dtype, device=key.device)
    return loc + scale * torch.tan(pi * (u - 0.5))


_reg("cauchy_op", _cauchy)


def cauchy_(x, loc=0, scale=1, name=None):
    x = as_tensor(x)
    return _refill(x, dispatch.apply("cauchy_op", [
        _key_tensor(x._data.device)], {
        "shape": tuple(x.shape), "loc": float(loc), "scale": float(scale),
        "dtype": _draw_dtype(x)}))


def _geometric(key, *, shape, p, dtype):
    # p is a Python float: its uniform and logs in float64 (x64)
    u = random_mod.uniform((key[0], key[1]), shape, torch.float64, 0.0, 1.0,
                           key.device)
    lp = torch.log1p(torch.tensor(-p, dtype=torch.float64,
                                  device=key.device))
    return (torch.floor(torch.log(u) / lp) + 1).to(dtype)


_reg("geometric_op", _geometric)


def geometric_(x, probs, name=None):
    x = as_tensor(x)
    dt = x._data.dtype if x._data.dtype != torch.bfloat16 else torch.float32
    return _refill(x, dispatch.apply("geometric_op", [
        _key_tensor(x._data.device)], {"shape": tuple(x.shape),
                                       "p": float(probs), "dtype": dt}))


def bernoulli_(x, p=0.5, name=None):
    from .comparison import less_than
    from .creation import rand

    return _refill(x, less_than(rand(tuple(x.shape)), p))


def _exponential(key, *, shape, lam, dtype):
    u = random_mod.uniform((key[0], key[1]), shape, dtype, 0.0, 1.0,
                           key.device)
    return -torch.log1p(-u) / lam


_reg("exponential_op", _exponential)


def exponential_(x, lam=1.0, name=None):
    x = as_tensor(x)
    dt = torch.float32 if x._data.dtype == torch.bfloat16 \
        else x._data.dtype
    return _refill(x, dispatch.apply("exponential_op", [
        _key_tensor(x._data.device)], {"shape": tuple(x.shape),
                                       "lam": float(lam), "dtype": dt}))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    from .creation import randint

    x = as_tensor(x)
    return randint(low, high, shape=tuple(x.shape),
                   dtype=dtype or x.dtype.name)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    """In-place uniform refill."""
    from .creation import uniform

    return inplace_rebind(x, uniform(tuple(x.shape), dtype=x.dtype.name,
                                     min=min, max=max, seed=seed))


def _top_p(x, ps, key):
    probs = torch.softmax(x.float(), dim=-1)
    sort_idx = torch.sort(-probs, dim=-1, stable=True).indices
    sorted_p = torch.gather(probs, -1, sort_idx)
    cum = torch.cumsum(sorted_p, -1)
    keep = (cum - sorted_p) < ps[..., None]
    filtered = torch.where(keep, sorted_p, torch.zeros((), device=x.device))
    filtered = filtered / filtered.sum(-1, keepdim=True)
    # jax.random.categorical: argmax of Gumbel noise (float32, the
    # logits' dtype) plus the log-probabilities
    tiny = float(torch.finfo(torch.float32).tiny)
    u = random_mod.uniform((key[0], key[1]), tuple(filtered.shape),
                           torch.float32, tiny, 1.0, x.device)
    g = -torch.log(-torch.log(u))
    draw = torch.argmax(g + torch.log(filtered + 1e-30), dim=-1)
    ids = torch.gather(sort_idx, -1, draw[..., None])
    vals = torch.gather(probs, -1, ids).to(x.dtype)
    return vals, ids.to(torch.int64)


_reg("top_p_sampling", _top_p, multi_out=True)


def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", return_top=False, name=None):
    """Nucleus sampling over the last axis: keep the smallest prefix of
    the sorted distribution whose exclusive prefix sum is below p,
    renormalise, draw one id (`jax.random.categorical`'s Gumbel-max).
    Returns (the drawn ids' probabilities, the ids)."""
    x = as_tensor(x)
    dev = x._data.device
    return tuple(dispatch.apply("top_p_sampling", [
        x, as_tensor(ps, device=dev), _key_tensor(dev)]))


# ---------------------------------------------------------------------------
# framework-surface helpers
# ---------------------------------------------------------------------------

class finfo:
    """The float dtype's limits (`np.finfo`'s fields)."""

    def __init__(self, dtype):
        d = dtype_mod.convert_dtype(dtype)
        info = torch.finfo(d.torch_dtype)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = self.tiny
        # numpy's resolution, a value of the dtype
        self.resolution = float(torch.tensor(info.resolution,
                                             dtype=d.torch_dtype))
        self.bits = int(info.bits)
        self.dtype = str(d)


class iinfo:
    """The integer dtype's limits."""

    def __init__(self, dtype):
        d = dtype_mod.convert_dtype(dtype)
        info = torch.iinfo(d.torch_dtype)
        self.min = int(info.min)
        self.max = int(info.max)
        self.bits = int(info.bits)
        self.dtype = str(d)


def tolist(x):
    return np.asarray(as_tensor(x).numpy()).tolist()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """numpy's print options (what `Tensor.__repr__` prints through)."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def disable_signal_handler():
    """No-op: no native signal handlers are installed."""


def batch(reader, batch_size, drop_last=False):
    """The reader decorator that yields lists of `batch_size` items."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


_reg("add_n", lambda *xs: builtins.sum(xs[1:], xs[0]))


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    if isinstance(inputs, Tensor):
        return inputs
    return dispatch.apply("add_n", [as_tensor(t) for t in inputs])


def addmm_(input, x, y, beta=1.0, alpha=1.0, name=None):
    from .math import addmm

    return inplace_rebind(input, addmm(input, x, y, beta=beta, alpha=alpha))


def check_shape(shape):
    for s in shape:
        if not isinstance(s, (int, np.integer)) and s is not None:
            raise TypeError(f"shape entries must be ints, got {type(s)}")


def create_tensor(dtype, name=None, persistable=False):
    """An empty tensor of `dtype`."""
    return Tensor(np.zeros((0,), dtype_mod.convert_dtype(dtype).np_dtype))


# ---------------------------------------------------------------------------
# the in-place table: each `<op>_` computes out of place and rebinds
# ---------------------------------------------------------------------------

def _make_inplace(fn):
    def api(x, *args, **kwargs):
        return inplace_rebind(x, fn(x, *args, **kwargs))

    api.__name__ = fn.__name__ + "_"
    return api


def _build_inplace_table():
    from . import comparison, creation, manipulation, math as m

    unary = {n: getattr(m, n) for n in (
        "abs", "acos", "asin", "atan", "sin", "cos", "tan", "sinh", "cosh",
        "tanh", "asinh", "acosh", "atanh", "erf", "exp", "expm1", "floor",
        "ceil", "round", "trunc", "sqrt", "rsqrt", "square", "reciprocal",
        "neg", "log", "log2", "log10", "log1p", "sigmoid", "digamma",
        "lgamma", "frac", "i0", "nan_to_num", "erfinv")}
    unary.update(logit=logit, sinc=sinc, gammaln=gammaln,
                 polygamma=polygamma, multigammaln=multigammaln,
                 renorm=renorm)
    binary = {n: getattr(m, n) for n in (
        "pow", "divide", "floor_divide", "remainder", "gcd", "lcm", "hypot",
        "copysign", "heaviside")}
    binary.update(mod=m.remainder, ldexp=ldexp, gammainc=gammainc,
                  gammaincc=gammaincc, masked_fill=manipulation.masked_fill,
                  masked_scatter=masked_scatter)
    binary.update({n: getattr(comparison, n) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
        "bitwise_right_shift", "logical_and", "logical_or", "logical_xor",
        "equal", "not_equal", "greater_equal", "greater_than", "less_equal",
        "less_than")})
    other = {"bitwise_not": comparison.bitwise_not,
             "logical_not": comparison.logical_not, "cumsum": m.cumsum,
             "cumprod": m.cumprod, "flatten": manipulation.flatten,
             "cast": manipulation.cast, "tril": creation.tril,
             "triu": creation.triu, "t": manipulation.t,
             "transpose": manipulation.transpose,
             "scatter": manipulation.scatter, "index_add": index_add,
             "index_fill": index_fill, "index_put": index_put,
             "lerp": m.lerp, "put_along_axis": manipulation.put_along_axis}
    table = {n + "_": _make_inplace(fn)
             for n, fn in {**unary, **binary, **other}.items()}
    table["floor_mod_"] = table["mod_"]
    return table


_INPLACE = _build_inplace_table()
globals().update(_INPLACE)

__all__ = [
    "hstack", "vstack", "dstack", "column_stack", "row_stack", "hsplit",
    "vsplit", "dsplit", "tensor_split", "atleast_1d", "atleast_2d",
    "atleast_3d", "block_diag", "unflatten", "unfold", "view", "view_as",
    "as_strided", "reverse", "take", "trace", "vander", "tril_indices",
    "triu_indices", "cartesian_prod", "combinations", "index_add",
    "index_fill", "index_put", "masked_scatter", "slice_scatter",
    "diagonal_scatter", "multiplex", "shard_index", "increment",
    "reduce_as", "cummax", "cummin", "kthvalue", "mode", "isin",
    "histogram_bin_edges", "histogramdd", "logit", "sinc", "gammaln", "i0e",
    "i1e", "gammainc", "gammaincc", "ldexp", "multigammaln", "polygamma",
    "frexp", "signbit", "sgn", "isneginf", "isposinf", "isreal",
    "is_complex", "is_floating_point", "is_integer", "complex", "polar",
    "renorm", "trapezoid", "cumulative_trapezoid", "cdist", "pdist",
    "nanquantile", "tensordot", "logspace", "standard_normal",
    "standard_gamma", "poisson", "binomial", "log_normal", "normal_",
    "log_normal_", "cauchy_", "geometric_", "bernoulli_", "exponential_",
    "randint_like", "finfo", "iinfo", "tolist", "set_printoptions",
    "disable_signal_handler", "batch", "check_shape", "add_n", "addmm_",
    "uniform_", "top_p_sampling", "create_tensor"] + sorted(_INPLACE)
