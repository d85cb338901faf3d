"""Activations: the port of `paddle_tpu/ops/activation.py`.

`swiglu`, the plain `paddle_tpu/ops/activation.py:193-202` the Llama
models call (their MLP does not reach the Pallas `bias_act` kernels), on
torch tensors as it is and on eager Tensors as the ops `swiglu` /
`swiglu_packed`; and on eager Tensors every other activation with the
formulas of `paddle_tpu/ops/activation.py:13-222` (an integer input is
cast to the default float dtype first by the `make_float_unary` ones):
`softmax` / `log_softmax`, `relu` / `relu6`, `sigmoid`, `silu` /
`swish`, `gelu` (the erf form unless `approximate`), `leaky_relu`,
`elu`, `celu`, `selu`, `hardswish`, `hardsigmoid`, `hardtanh` (JAX's
clip: a tie with a bound splits its gradient), `hardshrink`,
`softshrink`, `thresholded_relu`, `softsign`, `tanhshrink`,
`log_sigmoid`, `mish`, `softplus`, `prelu`, `glu`, `maxout` and
`rrelu`, whose training draw is `uniform(key, x.shape, x.dtype, lower,
upper)` on a key of the shared generator (the JAX package's bits).
`nn.functional` re-exports them, as the JAX package's does."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import dispatch
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ._helpers import as_tensor, cast_to, make_float_unary, normalize_axis

__all__ = ["swiglu", "softmax", "log_softmax", "relu", "relu6", "sigmoid",
           "tanh", "silu", "swish", "gelu", "leaky_relu", "elu", "celu",
           "selu", "hardswish", "hardsigmoid", "hardtanh", "hardshrink",
           "softshrink", "thresholded_relu", "softsign", "tanhshrink",
           "log_sigmoid", "mish", "softplus", "prelu", "rrelu", "glu",
           "maxout"]


def _swiglu(x, y=None):
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


dispatch.register_op("swiglu", _swiglu)
dispatch.register_op("swiglu_packed", _swiglu)


def swiglu(x, y=None, name=None):
    """`silu(x) * y`; with `y=None`, x is split in two halves along its
    last axis first. Eager Tensors go through the op, torch tensors give a
    torch tensor."""
    if isinstance(x, Tensor) or isinstance(y, Tensor):
        if y is None:
            return dispatch.apply("swiglu_packed", [x])
        return dispatch.apply("swiglu", [as_tensor(x), as_tensor(y)])
    return _swiglu(x, y)


dispatch.register_op("softmax", lambda x, *, axis: torch.softmax(x, dim=axis))


dispatch.register_op("log_softmax", lambda x, *, axis: torch.log_softmax(
    x, dim=axis))


def _softmax_like(opname, x, axis, dtype):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    elif not dtype_mod.is_inexact(x._data.dtype):
        x = cast_to(x, dtype_mod.get_default_dtype())
    return dispatch.apply(opname, [x], {"axis": int(axis)})


def softmax(x, axis=-1, dtype=None, name=None):
    return _softmax_like("softmax", x, axis, dtype)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return _softmax_like("log_softmax", x, axis, dtype)


relu = make_float_unary("relu", torch.relu)
relu6 = make_float_unary("relu6", F.relu6)
sigmoid = make_float_unary("sigmoid_act", torch.sigmoid)
tanh = make_float_unary("tanh_act", torch.tanh)
softsign = make_float_unary("softsign", lambda x: x / (torch.abs(x) + 1))
tanhshrink = make_float_unary("tanhshrink", lambda x: x - torch.tanh(x))
log_sigmoid = make_float_unary("log_sigmoid", F.logsigmoid)
silu = make_float_unary("silu", F.silu)
swish = silu
# x * tanh(softplus(x)), softplus as jax.nn.softplus: logaddexp(x, 0)
mish = make_float_unary("mish", lambda x: x * torch.tanh(
    torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))))

dispatch.register_op("gelu", lambda x, *, approximate: F.gelu(
    x, approximate="tanh" if approximate else "none"))


def gelu(x, approximate=False, name=None):
    return dispatch.apply("gelu", [as_tensor(x)],
                          {"approximate": bool(approximate)})


dispatch.register_op("leaky_relu", lambda x, *, slope: F.leaky_relu(x, slope))


def leaky_relu(x, negative_slope=0.01, name=None):
    return dispatch.apply("leaky_relu", [as_tensor(x)],
                          {"slope": float(negative_slope)})


dispatch.register_op("elu", lambda x, *, alpha: F.elu(x, alpha))


def elu(x, alpha=1.0, name=None):
    return dispatch.apply("elu", [as_tensor(x)], {"alpha": float(alpha)})


dispatch.register_op("celu", lambda x, *, alpha: F.celu(x, alpha))


def celu(x, alpha=1.0, name=None):
    return dispatch.apply("celu", [as_tensor(x)], {"alpha": float(alpha)})


dispatch.register_op("selu", lambda x, *, scale, alpha: scale * torch.where(
    x > 0, x, alpha * (torch.exp(x) - 1)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return dispatch.apply("selu", [as_tensor(x)],
                          {"scale": float(scale), "alpha": float(alpha)})


def _full(v, x):
    """A scalar in x's dtype, filled on x's device (no host copy)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    # jnp.clip: minimum(maximum(x, lo), hi), a tie's gradient split
    return torch.minimum(torch.maximum(x, _full(lo, x)), _full(hi, x))


dispatch.register_op("hardsigmoid", lambda x, *, slope, offset: _clip(
    slope * x + offset, 0.0, 1.0))


def hardsigmoid(x, slope=1 / 6, offset=0.5, name=None):
    return dispatch.apply("hardsigmoid", [as_tensor(x)],
                          {"slope": float(slope), "offset": float(offset)})


dispatch.register_op("hardtanh", lambda x, *, mn, mx: _clip(x, mn, mx))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return dispatch.apply("hardtanh", [as_tensor(x)],
                          {"mn": float(min), "mx": float(max)})


dispatch.register_op("hardshrink", lambda x, *, threshold: torch.where(
    torch.abs(x) > threshold, x, _full(0.0, x)))


def hardshrink(x, threshold=0.5, name=None):
    return dispatch.apply("hardshrink", [as_tensor(x)],
                          {"threshold": float(threshold)})


dispatch.register_op("softshrink", lambda x, *, threshold: torch.where(
    x > threshold, x - threshold, torch.where(
        x < -threshold, x + threshold, _full(0.0, x))))


def softshrink(x, threshold=0.5, name=None):
    return dispatch.apply("softshrink", [as_tensor(x)],
                          {"threshold": float(threshold)})


dispatch.register_op("thresholded_relu", lambda x, *, threshold, value:
                     torch.where(x > threshold, x, _full(value, x)))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return dispatch.apply("thresholded_relu", [as_tensor(x)],
                          {"threshold": float(threshold),
                           "value": float(value)})


# jax.nn.hard_swish: x * relu6(x + 3) / 6 (torch's CUDA kernel rounds a
# float64 input's constants to float32)
dispatch.register_op("hardswish", lambda x: x * F.relu6(x + 3.0) / 6.0)


def hardswish(x, name=None):
    return dispatch.apply("hardswish", [as_tensor(x)])


# x where beta * x > threshold, else softplus(beta * x) / beta
dispatch.register_op("softplus", lambda x, *, beta, threshold: F.softplus(
    x, beta, threshold))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return dispatch.apply("softplus", [as_tensor(x)],
                          {"beta": float(beta), "threshold": float(threshold)})


dispatch.register_op("prelu_op", lambda x, w: torch.where(x >= 0, x, w * x))


def prelu(x, weight, data_format="NCHW", name=None):
    """`where(x >= 0, x, w * x)`; a weight of several values runs along
    the channel axis (1 for NCHW, else the last)."""
    from .manipulation import reshape

    x, w = as_tensor(x), as_tensor(weight)
    if w.size > 1:
        shape = [1] * x.ndim
        shape[1 if data_format == "NCHW" else x.ndim - 1] = w.size
        w = reshape(w, shape)
    return dispatch.apply("prelu_op", [x, w])


dispatch.register_op("rrelu_eval", lambda x, *, lower, upper: torch.where(
    x >= 0, x, (lower + upper) / 2 * x))


def _rrelu_train(key, x, *, lower, upper):
    a = random_mod.uniform((key[0], key[1]), tuple(x.shape), x.dtype, lower,
                           upper, x.device)
    return torch.where(x >= 0, x, a * x)


dispatch.register_op("rrelu_train", _rrelu_train)


def rrelu(x, lower=1 / 8, upper=1 / 3, training=False, name=None):
    x = as_tensor(x)
    attrs = {"lower": float(lower), "upper": float(upper)}
    if training:
        key = torch.tensor(random_mod.next_key(), dtype=torch.int64,
                           device=x._data.device)
        return dispatch.apply("rrelu_train", [key, x], attrs)
    return dispatch.apply("rrelu_eval", [x], attrs)


dispatch.register_op("glu_op", lambda x, *, axis: F.glu(x, axis))


def glu(x, axis=-1, name=None):
    return dispatch.apply("glu_op", [as_tensor(x)], {"axis": int(axis)})


def _maxout(x, *, groups, axis):
    shp = list(x.shape)
    new_shape = shp[:axis] + [shp[axis] // groups, groups] + shp[axis + 1:]
    return torch.amax(x.reshape(new_shape), dim=axis + 1)


dispatch.register_op("maxout_op", _maxout)


def maxout(x, groups, axis=1, name=None):
    x = as_tensor(x)
    return dispatch.apply("maxout_op", [x], {
        "groups": int(groups), "axis": normalize_axis(axis, x.ndim)})
