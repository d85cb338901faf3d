"""The norm functionals: the port of `paddle_tpu/nn/functional/norm.py`.

`rms_norm` is routed as `norm.py:193-208` routes it: the fused kernel
(`ops/kernels/rms_norm.py`) when its `supported()` holds, else the plain
composite `_rms_norm_fn`. Eager `Tensor` inputs go through
`dispatch.apply("rms_norm", ...)` to the same routes and come back as a
`Tensor`. The others are plain composites on eager Tensors, as the JAX
package computes them outside any Pallas kernel:
- `batch_norm` (`norm.py:22-98`) runs its statistics the JAX package's
  way, not torch's: `new = momentum * running + (1 - momentum) * batch`
  (default momentum 0.9), normalizing with the biased batch variance and
  moving the running variance toward the unbiased one. In training the
  running buffers are rebound to the new statistics (which carry no
  gradient, as the JAX package's plain arrays do);
- `layer_norm`, `group_norm`, `instance_norm`: mean and biased variance,
  a division by `sqrt`;
- `local_response_norm`: a zero-padded window sum of squares over the
  channel axis; `normalize`: `x / max(||x||_p, eps)`.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...ops._helpers import as_tensor
from ...ops.kernels import rms_norm as _kernel

__all__ = ["batch_norm", "layer_norm", "group_norm", "instance_norm",
           "local_response_norm", "normalize", "rms_norm"]


def _bshape(v, x, c_axis):
    shape = [1] * x.dim()
    shape[c_axis] = v.shape[0]
    return v.reshape(shape)


def _c_axis(x, data_format):
    return 1 if data_format.startswith("NC") and x.dim() > 1 \
        else x.dim() - 1


def _bn_train_fn(x, mean, var, w, b, *, momentum, epsilon, data_format):
    c_axis = _c_axis(x, data_format)
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    batch_mean = x.mean(dim=axes)
    centered = x - _bshape(batch_mean, x, c_axis)
    batch_var = (centered ** 2).mean(dim=axes)
    inv = 1.0 / torch.sqrt(batch_var + epsilon)
    y = centered * _bshape(inv, x, c_axis)
    if w is not None:
        y = y * _bshape(w, x, c_axis)
    if b is not None:
        y = y + _bshape(b, x, c_axis)
    n = int(np.prod([x.shape[i] for i in axes]))
    unbiased = batch_var.detach() * (n / max(n - 1, 1))
    new_mean = momentum * mean + (1 - momentum) * batch_mean.detach()
    new_var = momentum * var + (1 - momentum) * unbiased
    return y, new_mean, new_var


def _bn_eval_fn(x, mean, var, w, b, *, epsilon, data_format):
    c_axis = _c_axis(x, data_format)
    inv = 1.0 / torch.sqrt(var + epsilon)
    y = (x - _bshape(mean, x, c_axis)) * _bshape(inv, x, c_axis)
    if w is not None:
        y = y * _bshape(w, x, c_axis)
    if b is not None:
        y = y + _bshape(b, x, c_axis)
    return y


def _register_bn():
    """The JAX package's op names (its AMP lists name the first two): the
    full op and `_w{0|1}b{0|1}` variants without a weight or a bias."""
    def variant(fn, has_w, has_b):
        def f(x, m, v, *wb, **kw):
            wb = list(wb)
            w = wb.pop(0) if has_w else None
            b = wb.pop(0) if has_b else None
            return fn(x, m, v, w, b, **kw)
        return f

    for name, fn, multi in (("batch_norm_train", _bn_train_fn, True),
                            ("batch_norm_eval", _bn_eval_fn, False)):
        dispatch.register_op(name, fn, multi_out=multi)
        for has_w in (0, 1):
            for has_b in (0, 1):
                if has_w and has_b:
                    continue
                dispatch.register_op(f"{name}_w{has_w}b{has_b}",
                                     variant(fn, has_w, has_b),
                                     multi_out=multi)


_register_bn()


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    x = as_tensor(x)
    rm, rv = as_tensor(running_mean), as_tensor(running_var)
    args = [x, rm, rv] + ([as_tensor(weight)] if weight is not None
                          else []) \
        + ([as_tensor(bias)] if bias is not None else [])
    suffix = "" if weight is not None and bias is not None else \
        f"_w{int(weight is not None)}b{int(bias is not None)}"
    if use_global_stats is None:
        use_global_stats = not training
    if training and not use_global_stats:
        y, new_mean, new_var = dispatch.apply(
            "batch_norm_train" + suffix, args,
            {"momentum": float(momentum), "epsilon": float(epsilon),
             "data_format": data_format})
        # the running statistics move in place of the buffers' values
        running_mean._data = new_mean._data
        running_var._data = new_var._data
        return y
    return dispatch.apply("batch_norm_eval" + suffix, args,
                          {"epsilon": float(epsilon),
                           "data_format": data_format})


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


def _gn_fn(x, w, b, *, num_groups, epsilon, data_format):
    channel_last = data_format.endswith("C") \
        and not data_format.startswith("NC")
    if channel_last:
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    xg = x.reshape((n, num_groups, c // num_groups) + spatial)
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=axes, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + epsilon)).reshape(x.shape)
    shape = (1, c) + (1,) * len(spatial)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    if channel_last:
        y = torch.movedim(y, 1, -1)
    return y


dispatch.register_op("group_norm", _gn_fn)
dispatch.register_op("group_norm_nowb", lambda x, **kw: _gn_fn(
    x, None, None, **kw))


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW", name=None):
    """A missing weight or bias (not both) is ones / zeros, as in the JAX
    package."""
    x = as_tensor(x)
    attrs = {"num_groups": int(num_groups), "epsilon": float(epsilon),
             "data_format": data_format}
    if weight is None and bias is None:
        return dispatch.apply("group_norm_nowb", [x], attrs)
    c = x.shape[1]
    w = as_tensor(weight) if weight is not None else Tensor._wrap(
        torch.ones(c, dtype=x._data.dtype, device=x._data.device))
    b = as_tensor(bias) if bias is not None else Tensor._wrap(
        torch.zeros(c, dtype=x._data.dtype, device=x._data.device))
    return dispatch.apply("group_norm", [x, w, b], attrs)


def _in_fn(x, w, b, *, epsilon):
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + epsilon)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y


dispatch.register_op("instance_norm", _in_fn)
dispatch.register_op("instance_norm_nowb",
                     lambda x, *, epsilon: _in_fn(x, None, None,
                                                  epsilon=epsilon))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Statistics of each instance and channel over the spatial axes (the
    running statistics are accepted and unused, as in the JAX
    package)."""
    x = as_tensor(x)
    if weight is None and bias is None:
        return dispatch.apply("instance_norm_nowb", [x],
                              {"epsilon": float(eps)})
    c = x.shape[1]
    w = as_tensor(weight) if weight is not None else Tensor._wrap(
        torch.ones(c, dtype=x._data.dtype, device=x._data.device))
    b = as_tensor(bias) if bias is not None else Tensor._wrap(
        torch.zeros(c, dtype=x._data.dtype, device=x._data.device))
    return dispatch.apply("instance_norm", [x, w, b],
                          {"epsilon": float(eps)})


def _lrn_fn(x, *, size, alpha, beta, k, data_format):
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = torch.movedim(x * x, c_axis, -1)
    half = size // 2
    padded = torch.nn.functional.pad(sq, (half, size - half - 1))
    summed = padded.unfold(-1, size, 1).sum(dim=-1)
    div = (k + alpha * torch.movedim(summed, -1, c_axis)) ** beta
    return x / div


dispatch.register_op("local_response_norm", _lrn_fn)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return dispatch.apply("local_response_norm", [as_tensor(x)],
                          {"size": int(size), "alpha": float(alpha),
                           "beta": float(beta), "k": float(k),
                           "data_format": data_format})


def _normalize_fn(x, *, p, axis, epsilon):
    if p == 2.0:
        norm = torch.sqrt((x * x).sum(dim=axis, keepdim=True))
    else:
        norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


dispatch.register_op("fn_normalize", _normalize_fn)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return dispatch.apply("fn_normalize", [as_tensor(x)],
                          {"p": float(p), "axis": int(axis),
                           "epsilon": float(epsilon)})
