"""Elementwise math: the port of `paddle_tpu/ops/math.py`.

Every op registers under the JAX package's op name, so the AMP lists and
the lazy recorder key on the same names. Semantics as JAX computes them:
- `round` rounds half away from zero (phi's `RoundFunctor`,
  `std::round`): `trunc(|x| + 0.5) * sign(x)`, after a shift by
  10^decimals; `torch.round` rounds half to even and is not used.
- `remainder` / `mod` / `floor_mod` take the sign of the divisor, as
  `jnp.remainder` (and `torch.remainder`) do.
- `divide`, `atan2`, `hypot` and `logaddexp` cast integer operands to the
  default float dtype first; the float unaries cast an integer input.
- `cumsum` / `cumprod` keep an integer input's dtype (`jnp.cumsum`; torch
  would widen to int64) and count a bool input in int64; `axis=None` runs
  over the flattened tensor.
- `nan_to_num` maps the infinities to the dtype's extremes unless given.
- `imag` of a real tensor is zeros (`jnp.imag`), `conj` of a real tensor
  is the tensor.
- `maximum` / `minimum` and `clip` (ops `clip`, `clip_min`, `clip_max`,
  bounds promoted against x as `paddle_tpu/ops/math.py:140-155` does,
  `jnp.clip`'s `minimum(maximum(x, lo), hi)`) split a tie's gradient
  equally, as `jnp.maximum` does.
The in-place `_` forms rebind as `_helpers.inplace_rebind` says.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ._helpers import (as_tensor, cast_to, inplace_rebind, make_binary,
                       make_float_unary, make_unary, normalize_axis,
                       prep_binary)

__all__ = ["add", "subtract", "multiply", "divide", "floor_divide",
           "remainder", "mod", "floor_mod", "maximum", "minimum", "fmax",
           "fmin", "atan2", "hypot", "logaddexp", "nextafter", "copysign",
           "heaviside", "gcd", "lcm", "inner", "pow", "exp", "expm1", "log",
           "log1p", "log2", "log10", "sqrt", "rsqrt", "abs", "absolute",
           "sign", "floor", "ceil", "round", "trunc", "frac", "square",
           "reciprocal", "neg", "sin", "cos", "tan", "asin", "acos", "atan",
           "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "erf",
           "erfinv", "sigmoid", "digamma", "lgamma", "i0", "i1", "angle",
           "conj", "real", "imag", "deg2rad", "rad2deg", "isnan", "isinf",
           "isfinite", "scale", "clip", "lerp", "stanh", "cumsum", "cumprod",
           "logcumsumexp", "addmm", "outer", "inner_product", "kron", "diff",
           "nan_to_num", "multiply_", "add_", "subtract_", "scale_",
           "clip_"]

# -- binary arithmetic -------------------------------------------------------
add = make_binary("add", torch.add)
subtract = make_binary("subtract", torch.sub)
multiply = make_binary("multiply", torch.mul)
divide = make_binary("divide", torch.true_divide, float_only=True)
floor_divide = make_binary("floor_divide", torch.floor_divide)
remainder = make_binary("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
maximum = make_binary("maximum", torch.maximum)
minimum = make_binary("minimum", torch.minimum)
fmax = make_binary("fmax", torch.fmax)
fmin = make_binary("fmin", torch.fmin)
atan2 = make_binary("atan2", torch.atan2, float_only=True)
hypot = make_binary("hypot", torch.hypot, float_only=True)
logaddexp = make_binary("logaddexp", torch.logaddexp, float_only=True)
nextafter = make_binary("nextafter", torch.nextafter)
copysign = make_binary("copysign", torch.copysign)
heaviside = make_binary("heaviside", torch.heaviside)
gcd = make_binary("gcd", torch.gcd)
lcm = make_binary("lcm", torch.lcm)
inner = make_binary("inner_elem", torch.inner)

dispatch.register_op("pow_scalar", lambda a, *, exp: torch.pow(a, exp))
dispatch.register_op("elementwise_pow", torch.pow)


def pow(x, y, name=None):
    if isinstance(y, (int, float)) and not isinstance(y, bool):
        return dispatch.apply("pow_scalar", [as_tensor(x)], {"exp": y})
    return dispatch.apply("elementwise_pow", list(prep_binary(x, y)))


# -- unary -------------------------------------------------------------------
def _frac(x):
    return x - torch.trunc(x)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _conj(x):
    return torch.conj_physical(x) if x.is_complex() else x.clone()


exp = make_float_unary("exp", torch.exp)
expm1 = make_float_unary("expm1", torch.expm1)
log = make_float_unary("log", torch.log)
log1p = make_float_unary("log1p", torch.log1p)
log2 = make_float_unary("log2", torch.log2)
log10 = make_float_unary("log10", torch.log10)
sqrt = make_float_unary("sqrt", torch.sqrt)
rsqrt = make_float_unary("rsqrt", torch.rsqrt)
abs = make_unary("abs", torch.abs)
absolute = abs
sign = make_unary("sign", torch.sign)
floor = make_unary("floor", torch.floor)
ceil = make_unary("ceil", torch.ceil)
trunc = make_unary("trunc", torch.trunc)
frac = make_unary("frac", _frac)
square = make_unary("square", torch.square)
reciprocal = make_float_unary("reciprocal", torch.reciprocal)
neg = make_unary("neg", torch.neg)
sin = make_float_unary("sin", torch.sin)
cos = make_float_unary("cos", torch.cos)
tan = make_float_unary("tan", torch.tan)
asin = make_float_unary("asin", torch.asin)
acos = make_float_unary("acos", torch.acos)
atan = make_float_unary("atan", torch.atan)
sinh = make_float_unary("sinh", torch.sinh)
cosh = make_float_unary("cosh", torch.cosh)
tanh = make_float_unary("tanh", torch.tanh)
asinh = make_float_unary("asinh", torch.asinh)
acosh = make_float_unary("acosh", torch.acosh)
atanh = make_float_unary("atanh", torch.atanh)
erf = make_float_unary("erf", torch.erf)
erfinv = make_float_unary("erfinv", torch.erfinv)
sigmoid = make_float_unary("sigmoid", torch.sigmoid)
digamma = make_float_unary("digamma", torch.digamma)
lgamma = make_float_unary("lgamma", torch.lgamma)
i0 = make_float_unary("i0", torch.i0)
i1 = make_float_unary("i1", torch.special.i1)
angle = make_unary("angle", torch.angle)
conj = make_unary("conj", _conj)
real = make_unary("real", lambda x: torch.real(x).clone())
imag = make_unary("imag", _imag)
deg2rad = make_float_unary("deg2rad", torch.deg2rad)
rad2deg = make_float_unary("rad2deg", torch.rad2deg)

isnan = make_unary("isnan", torch.isnan)
isinf = make_unary("isinf", torch.isinf)
isfinite = make_unary("isfinite", torch.isfinite)


def _round_away(x, *, decimals):
    if decimals:
        f = 10.0 ** decimals
        return torch.trunc(torch.abs(x * f) + 0.5) * torch.sign(x) / f
    return torch.trunc(torch.abs(x) + 0.5) * torch.sign(x)


dispatch.register_op("round", _round_away)


def round(x, decimals=0, name=None):
    return dispatch.apply("round", [as_tensor(x)], {"decimals": int(decimals)})


# -- scale / clip / lerp -----------------------------------------------------
dispatch.register_op(
    "scale", lambda x, *, scale, bias, bias_after_scale:
    x * scale + bias if bias_after_scale else (x + bias) * scale)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = dispatch.apply("scale", [as_tensor(x)],
                         {"scale": float(scale), "bias": float(bias),
                          "bias_after_scale": bool(bias_after_scale)})
    if act is not None:
        from . import activation

        out = getattr(activation, act)(out)
    return out


dispatch.register_op("clip", lambda x, lo, hi: torch.minimum(
    torch.maximum(x, lo), hi))
dispatch.register_op("clip_min", lambda x, lo: torch.maximum(x, lo))
dispatch.register_op("clip_max", lambda x, hi: torch.minimum(x, hi))


def clip(x, min=None, max=None, name=None):
    x = as_tensor(x)
    if min is not None and max is not None:
        _, lo = prep_binary(x, min)
        _, hi = prep_binary(x, max)
        return dispatch.apply("clip", [x, lo, hi])
    if min is not None:
        _, lo = prep_binary(x, min)
        return dispatch.apply("clip_min", [x, lo])
    if max is not None:
        _, hi = prep_binary(x, max)
        return dispatch.apply("clip_max", [x, hi])
    return x


dispatch.register_op("lerp", lambda x, y, w: x + w * (y - x))


def lerp(x, y, weight, name=None):
    x, y = prep_binary(x, y)
    if not isinstance(weight, Tensor):
        weight = as_tensor(float(weight), dtype=x.dtype,
                           device=x._data.device)
    return dispatch.apply("lerp", [x, y, weight])


dispatch.register_op("stanh", lambda x, *, a, b: b * torch.tanh(a * x))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return dispatch.apply("stanh", [as_tensor(x)],
                          {"a": float(scale_a), "b": float(scale_b)})


# -- cumulative --------------------------------------------------------------
def _cum_dtype(x):
    """jnp's accumulation dtype: an integer input's own, bool int64."""
    return torch.int64 if x.dtype == torch.bool else x.dtype


dispatch.register_op("cumsum", lambda x, *, axis: torch.cumsum(
    x, axis, dtype=_cum_dtype(x)))
dispatch.register_op("cumsum_flat", lambda x: torch.cumsum(
    x.reshape(-1), 0, dtype=_cum_dtype(x)))
dispatch.register_op("cumprod", lambda x, *, axis: torch.cumprod(
    x.reshape(-1) if axis is None else x, 0 if axis is None else axis,
    dtype=_cum_dtype(x)))
dispatch.register_op("logcumsumexp", lambda x, *, axis: torch.logcumsumexp(
    x, axis))


def cumsum(x, axis=None, dtype=None, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    if axis is None:
        return dispatch.apply("cumsum_flat", [x])
    return dispatch.apply("cumsum", [x], {"axis": normalize_axis(axis,
                                                                 x.ndim)})


def cumprod(x, dim=None, dtype=None, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    return dispatch.apply("cumprod", [x], {"axis": normalize_axis(dim,
                                                                  x.ndim)})


def logcumsumexp(x, axis=None, dtype=None, name=None):
    x = as_tensor(x)
    if axis is None:
        from .manipulation import reshape

        x = reshape(x, [-1])
        axis = 0
    return dispatch.apply("logcumsumexp", [x],
                          {"axis": normalize_axis(axis, x.ndim)})


# -- misc --------------------------------------------------------------------
dispatch.register_op("addmm", lambda inp, x, y, *, alpha, beta:
                     beta * inp + alpha * (x @ y))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return dispatch.apply("addmm", [as_tensor(input), as_tensor(x),
                                    as_tensor(y)],
                          {"alpha": float(alpha), "beta": float(beta)})


dispatch.register_op("outer", lambda x, y: torch.outer(x.reshape(-1),
                                                       y.reshape(-1)))


def outer(x, y, name=None):
    return dispatch.apply("outer", list(prep_binary(x, y)))


dispatch.register_op("inner_prod", torch.inner)


def inner_product(x, y, name=None):
    return dispatch.apply("inner_prod", list(prep_binary(x, y)))


dispatch.register_op("kron", torch.kron)


def kron(x, y, name=None):
    return dispatch.apply("kron", list(prep_binary(x, y)))


dispatch.register_op("diff_op", lambda x, *, n, axis: torch.diff(
    x, n=n, dim=axis))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = as_tensor(x)
    if prepend is not None or append is not None:
        from .manipulation import concat

        parts = [as_tensor(prepend)] if prepend is not None else []
        parts.append(x)
        if append is not None:
            parts.append(as_tensor(append))
        x = concat(parts, axis=axis)
    return dispatch.apply("diff_op", [x], {"n": int(n), "axis": int(axis)})


dispatch.register_op("nan_to_num", lambda x, *, nan, posinf, neginf:
                     torch.nan_to_num(x, nan=nan, posinf=posinf,
                                      neginf=neginf))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return dispatch.apply("nan_to_num", [as_tensor(x)],
                          {"nan": nan, "posinf": posinf, "neginf": neginf})


def multiply_(x, y):
    return inplace_rebind(x, multiply(x, y))


def add_(x, y):
    return inplace_rebind(x, add(x, y))


def subtract_(x, y):
    return inplace_rebind(x, subtract(x, y))


def scale_(x, scale_v=1.0, bias=0.0, bias_after_scale=True, act=None):
    return inplace_rebind(x, scale(x, scale_v, bias, bias_after_scale, act))


def clip_(x, min=None, max=None):
    return inplace_rebind(x, clip(x, min, max))
