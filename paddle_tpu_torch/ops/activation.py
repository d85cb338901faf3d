"""Activations: `swiglu`, the plain `paddle_tpu/ops/activation.py:193-202`
the Llama models call (their MLP does not reach the Pallas `bias_act`
kernels), on torch tensors as it is and on eager Tensors as the ops
`swiglu` / `swiglu_packed`; and on eager Tensors `softmax`,
`relu`, `sigmoid`, `silu` / `swish`, `gelu` (the erf form unless
`approximate`), `leaky_relu`, `elu`, `hardswish`, `mish`, `softplus` and
`prelu`, the formulas of `paddle_tpu/ops/activation.py:13-165` (an
integer input is cast to the default float dtype first).
`nn.functional` re-exports them, as the JAX package's does."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import dispatch
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from ._helpers import as_tensor, cast_to, make_float_unary

__all__ = ["swiglu", "softmax", "relu", "sigmoid", "silu", "swish", "gelu",
           "leaky_relu", "elu", "hardswish", "mish", "softplus", "prelu"]


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


def softmax(x, axis=-1, dtype=None, name=None):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    elif not dtype_mod.is_inexact(x._data.dtype):
        x = cast_to(x, dtype_mod.get_default_dtype())
    return dispatch.apply("softmax", [x], {"axis": int(axis)})


relu = make_float_unary("relu", torch.relu)
sigmoid = make_float_unary("sigmoid_act", torch.sigmoid)
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


dispatch.register_op("hardswish", F.hardswish)


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
