"""Reductions: the port of `paddle_tpu/ops/reduction.py`.

`axis=None` reduces every axis, and `keepdim` keeps them as size 1.
Semantics as JAX computes them:
- `max` / `min` / `amax` / `amin` share the gradient equally among tied
  elements, as `jnp.max` does;
- `sum` of bool counts in int64; `mean`, `std`, `var`, `logsumexp`,
  `median` and `nanmedian` of an integer tensor are in the default float
  dtype;
- `argmax` / `argmin` return the first extremal index (int64 by default)
  and stop gradient;
- `std` / `var` are unbiased unless `unbiased=False`;
- `logsumexp` of a row of `-inf` is `-inf` (the max is taken as 0 where
  it is not finite, as `jax.scipy.special.logsumexp` does);
- `median` / `nanmedian` average the two middle values of an even count
  (JAX's `mode="avg"`; `torch.median` takes the lower one and is not
  used);
- `quantile` interpolates linearly, as `jnp.quantile`;
- `count_nonzero` gives int64.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dispatch
from ..framework import dtype as dtype_mod
from ._helpers import as_tensor, cast_to, normalize_axis

__all__ = ["sum", "mean", "max", "min", "amax", "amin", "prod", "all",
           "any", "argmax", "argmin", "logsumexp", "std", "var", "nanmean",
           "nansum", "median", "nanmedian", "quantile", "count_nonzero"]


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _keep(fn):
    """A reduction over `axis` (all axes for None) that leaves a 0-d
    tensor as it is."""
    def f(x, *, axis, keepdim):
        if x.dim() == 0:
            return fn(x.reshape(1), (0,), False)
        return fn(x, _dims(x, axis), keepdim)
    return f


dispatch.register_op("reduce_sum", _keep(lambda x, d, k: torch.sum(
    x, dim=d, keepdim=k)))
dispatch.register_op("reduce_mean", _keep(lambda x, d, k: torch.mean(
    x, dim=d, keepdim=k)))
dispatch.register_op("reduce_max", lambda x, *, axis, keepdim: torch.amax(
    x, dim=_dims(x, axis), keepdim=keepdim))
dispatch.register_op("reduce_min", lambda x, *, axis, keepdim: torch.amin(
    x, dim=_dims(x, axis), keepdim=keepdim))


def _prod(x, dims, keepdim):
    for a in sorted(dims, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


dispatch.register_op("reduce_prod", _keep(_prod))


def _reduce_bool(fn):
    def f(x, *, axis, keepdim):
        x = x.bool()
        for a in sorted(_dims(x, axis), reverse=True):
            x = fn(x, dim=a, keepdim=keepdim)
        return x
    return f


dispatch.register_op("reduce_all", _reduce_bool(torch.all))
dispatch.register_op("reduce_any", _reduce_bool(torch.any))


def _arg(fn):
    def f(x, *, axis, keepdim, dtype):
        if axis is None:
            out = fn(x.reshape(-1))
            if keepdim:
                out = out.reshape((1,) * x.dim())
        else:
            out = fn(x, dim=axis, keepdim=keepdim)
        return out.to(dtype)
    return f


dispatch.register_op("argmax", _arg(torch.argmax))
dispatch.register_op("argmin", _arg(torch.argmin))


def _logsumexp(x, dims, keepdim):
    m = torch.amax(x, dim=dims, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros((), dtype=m.dtype,
                                                      device=m.device))
    out = torch.log(torch.sum(torch.exp(x - m), dim=dims, keepdim=True)) + m
    return out if keepdim else out.squeeze(dims) if dims else out


dispatch.register_op("logsumexp", _keep(_logsumexp))
dispatch.register_op("reduce_std", lambda x, *, axis, keepdim, ddof:
                     torch.std(x, dim=_dims(x, axis), correction=ddof,
                               keepdim=keepdim))
dispatch.register_op("reduce_var", lambda x, *, axis, keepdim, ddof:
                     torch.var(x, dim=_dims(x, axis), correction=ddof,
                               keepdim=keepdim))
dispatch.register_op("nanmean", lambda x, *, axis, keepdim: torch.nanmean(
    x, dim=_dims(x, axis), keepdim=keepdim))
dispatch.register_op("nansum", _keep(lambda x, d, k: torch.nansum(
    x, dim=d, keepdim=k)))


def _flat_last(x, axis):
    """x with the reduced axes moved last and flattened into one, and
    the kept axes' shape."""
    dims = _dims(x, axis)
    rest = [i for i in range(x.dim()) if i not in dims]
    y = x.permute(rest + list(dims))
    return y.reshape([x.shape[i] for i in rest] + [-1]), dims


def _restore(out, x, dims, keepdim):
    if keepdim:
        shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
        return out.reshape(shape)
    return out


def _quantile_sorted(s, n, q):
    """Linear interpolation at q of the sorted last axis `s` of `n`
    values."""
    pos = q * (n - 1)
    lo = int(pos)
    hi = builtins.min(lo + 1, n - 1)
    a, b = s[..., lo], s[..., hi]
    return a + (b - a) * (pos - lo)


def _median(x, *, axis, keepdim):
    y, dims = _flat_last(x, axis)
    s, _ = torch.sort(y, dim=-1)
    n = s.shape[-1]
    lo, hi = (n - 1) // 2, n // 2
    out = (s[..., lo] + s[..., hi]) / 2 if lo != hi else s[..., lo]
    out = torch.where(torch.isnan(y).any(-1), torch.full(
        (), float("nan"), dtype=y.dtype, device=y.device), out)
    return _restore(out, x, dims, keepdim)


def _nanmedian(x, *, axis, keepdim):
    y, dims = _flat_last(x, axis)
    # NaNs sort last: the first `count` values are the valid ones
    s, _ = torch.sort(y, dim=-1)
    count = (~torch.isnan(y)).sum(-1)
    lo = torch.div(count - 1, 2, rounding_mode="floor").clamp(min=0)
    hi = torch.div(count, 2, rounding_mode="floor").clamp(
        max=builtins.max(s.shape[-1] - 1, 0))
    a = s.gather(-1, lo.unsqueeze(-1)).squeeze(-1)
    b = s.gather(-1, hi.unsqueeze(-1)).squeeze(-1)
    out = torch.where(lo == hi, a, (a + b) / 2)
    out = torch.where(count == 0, torch.full((), float("nan"),
                                             dtype=y.dtype, device=y.device),
                      out)
    return _restore(out, x, dims, keepdim)


dispatch.register_op("median_op", _median)
dispatch.register_op("nanmedian_op", _nanmedian)


def _quantile(x, *, q, axis, keepdim):
    y, dims = _flat_last(x, axis)
    s, _ = torch.sort(y, dim=-1)
    n = s.shape[-1]
    qs = q if isinstance(q, tuple) else (q,)
    outs = [_restore(_quantile_sorted(s, n, float(qv)), x, dims, keepdim)
            for qv in qs]
    return torch.stack(outs) if isinstance(q, tuple) else outs[0]


dispatch.register_op("quantile_op", _quantile)
dispatch.register_op("count_nonzero", lambda x, *, axis, keepdim:
                     torch.sum(x != 0, dim=_dims(x, axis), keepdim=keepdim)
                     .to(torch.int64))


def _reduce(opname, x, axis, keepdim, extra=None, cast_int_to=None):
    x = as_tensor(x)
    if cast_int_to is not None and not dtype_mod.is_inexact(x._data.dtype):
        x = cast_to(x, cast_int_to)
    attrs = {"axis": normalize_axis(axis, x.ndim), "keepdim": bool(keepdim)}
    if extra:
        attrs.update(extra)
    return dispatch.apply(opname, [x], attrs)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    elif x.dtype == dtype_mod.bool_:
        x = cast_to(x, "int64")
    return _reduce("reduce_sum", x, axis, keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_mean", x, axis, keepdim,
                   cast_int_to=dtype_mod.get_default_dtype())


def max(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_max", x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_min", x, axis, keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_max", x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_min", x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    return _reduce("reduce_prod", x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_all", x, axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_any", x, axis, keepdim)


def _argext(opname, x, axis, keepdim, dtype):
    x = as_tensor(x)
    return dispatch.apply(opname, [x], {
        "axis": normalize_axis(axis, x.ndim), "keepdim": bool(keepdim),
        "dtype": dtype_mod.to_torch(dtype)})


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _argext("argmax", x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _argext("argmin", x, axis, keepdim, dtype)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _reduce("logsumexp", x, axis, keepdim,
                   cast_int_to=dtype_mod.get_default_dtype())


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce("reduce_std", x, axis, keepdim,
                   {"ddof": 1 if unbiased else 0},
                   cast_int_to=dtype_mod.get_default_dtype())


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce("reduce_var", x, axis, keepdim,
                   {"ddof": 1 if unbiased else 0},
                   cast_int_to=dtype_mod.get_default_dtype())


def nanmean(x, axis=None, keepdim=False, name=None):
    return _reduce("nanmean", x, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    return _reduce("nansum", x, axis, keepdim)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return _reduce("median_op", x, axis, keepdim,
                   cast_int_to=dtype_mod.get_default_dtype())


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _reduce("nanmedian_op", x, axis, keepdim,
                   cast_int_to=dtype_mod.get_default_dtype())


def quantile(x, q, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    qv = tuple(float(v) for v in q) if isinstance(q, (list, tuple)) \
        else float(q)
    return dispatch.apply("quantile_op", [x],
                          {"q": qv, "axis": normalize_axis(axis, x.ndim),
                           "keepdim": bool(keepdim)})


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _reduce("count_nonzero", x, axis, keepdim)
