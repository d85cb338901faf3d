"""`rms_norm`, routed as `paddle_tpu/nn/functional/norm.py:193-208`
routes it: the fused kernel (`ops/kernels/rms_norm.py`) when its
`supported()` holds, else the plain composite `_rms_norm_fn`. Eager
`Tensor` inputs go through `dispatch.apply("rms_norm", ...)` to the same
routes and come back as a `Tensor`. `layer_norm` on eager Tensors is the
plain `norm.py:136-173`."""
from __future__ import annotations

import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...ops._helpers import as_tensor
from ...ops.kernels import rms_norm as _kernel

__all__ = ["rms_norm", "layer_norm"]


def _rms_norm_fn(x, w, epsilon):
    """`norm.py:180-187`: f32 math for 16-bit x, a division by `sqrt` (not
    the kernel's `rsqrt`), rounded to x's dtype before the multiply by w."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf / torch.sqrt(var + epsilon)
    return y.to(x.dtype) * w


def _rms_norm(x, weight, *, epsilon):
    if _kernel.supported(tuple(x.shape), x.dtype):
        return _kernel.rms_norm(x, weight, epsilon)
    return _rms_norm_fn(x, weight, epsilon)


dispatch.register_op("rms_norm", _rms_norm)


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last axis of x. A shape the kernel module admits
    always takes the kernel's path (its plain version on CPU tensors); a
    CUDA tensor never falls back from it."""
    if isinstance(x, Tensor) or isinstance(weight, Tensor):
        return dispatch.apply("rms_norm", [as_tensor(x), as_tensor(weight)],
                              {"epsilon": float(epsilon)})
    return _rms_norm(x, weight, epsilon=epsilon)


def _ln_fn(x, w, b, *, norm_ndim, epsilon):
    """`norm.py:136-148`: mean and biased variance over the last
    `norm_ndim` axes, a division by `sqrt`, then weight and bias."""
    axes = tuple(range(x.dim() - norm_ndim, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + epsilon)
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y


# the JAX package's four ops (its AMP lists name each)
dispatch.register_op("layer_norm", _ln_fn)
dispatch.register_op("layer_norm_now", lambda x, b, **kw: _ln_fn(
    x, None, b, **kw))
dispatch.register_op("layer_norm_nob", lambda x, w, **kw: _ln_fn(
    x, w, None, **kw))
dispatch.register_op("layer_norm_nowb", lambda x, **kw: _ln_fn(
    x, None, None, **kw))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    x = as_tensor(x)
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    attrs = {"norm_ndim": len(list(normalized_shape)),
             "epsilon": float(epsilon)}
    if weight is not None and bias is not None:
        return dispatch.apply("layer_norm",
                              [x, as_tensor(weight), as_tensor(bias)], attrs)
    if weight is not None:
        return dispatch.apply("layer_norm_nob", [x, as_tensor(weight)], attrs)
    if bias is not None:
        return dispatch.apply("layer_norm_now", [x, as_tensor(bias)], attrs)
    return dispatch.apply("layer_norm_nowb", [x], attrs)
