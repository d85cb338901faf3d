"""Elementwise math (the port's subset of `paddle_tpu/ops/math.py`).

`round` rounds half away from zero (phi's `RoundFunctor`, `std::round`),
as the JAX package writes it: `trunc(|x| + 0.5) * sign(x)`, after a
shift by 10^decimals; `torch.round` rounds half to even and is not used.
`divide` casts integer operands to the default float dtype first. The
in-place `add_` rebinds as `_helpers.inplace_rebind` says. `maximum` /
`minimum` and `clip` (ops `clip`, `clip_min`, `clip_max`, bounds
promoted against x as `paddle_tpu/ops/math.py:140-155` does, `jnp.clip`'s
`minimum(maximum(x, lo), hi)`) split a tie's gradient equally, as
`jnp.maximum` does.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ._helpers import (as_tensor, inplace_rebind, make_binary,
                       make_float_unary, make_unary, prep_binary)

__all__ = ["add", "subtract", "multiply", "divide", "floor_divide",
           "remainder", "maximum", "minimum", "pow", "exp", "log", "sqrt",
           "sin", "tanh", "sigmoid", "abs", "neg", "round", "scale", "clip",
           "add_"]

add = make_binary("add", torch.add)
subtract = make_binary("subtract", torch.sub)
multiply = make_binary("multiply", torch.mul)
divide = make_binary("divide", torch.true_divide, float_only=True)
floor_divide = make_binary("floor_divide", torch.floor_divide)
remainder = make_binary("remainder", torch.remainder)
maximum = make_binary("maximum", torch.maximum)
minimum = make_binary("minimum", torch.minimum)

exp = make_float_unary("exp", torch.exp)
log = make_float_unary("log", torch.log)
sqrt = make_float_unary("sqrt", torch.sqrt)
sin = make_float_unary("sin", torch.sin)
tanh = make_float_unary("tanh", torch.tanh)
sigmoid = make_float_unary("sigmoid", torch.sigmoid)
abs = make_unary("abs", torch.abs)
neg = make_unary("neg", torch.neg)

dispatch.register_op("pow_scalar", lambda a, *, exp: torch.pow(a, exp))
dispatch.register_op("elementwise_pow", torch.pow)


def pow(x, y, name=None):
    if isinstance(y, (int, float)) and not isinstance(y, bool):
        return dispatch.apply("pow_scalar", [as_tensor(x)], {"exp": y})
    return dispatch.apply("elementwise_pow", list(prep_binary(x, y)))


def _round_away(x, *, decimals):
    if decimals:
        f = 10.0 ** decimals
        return torch.trunc(torch.abs(x * f) + 0.5) * torch.sign(x) / f
    return torch.trunc(torch.abs(x) + 0.5) * torch.sign(x)


dispatch.register_op("round", _round_away)


def round(x, decimals=0, name=None):
    return dispatch.apply("round", [as_tensor(x)], {"decimals": int(decimals)})


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


def add_(x, y):
    return inplace_rebind(x, add(x, y))

