"""Pooling: the port of `paddle_tpu/nn/functional/pooling.py`.

The JAX package pools with `lax.reduce_window` (no Pallas kernel); the
port pads with the reduction's identity and reduces over `Tensor.unfold`
windows, which gives `reduce_window`'s semantics exactly:
- the pads: ints, per-axis, per-side, `"SAME"` / `"VALID"`
  (`lax.padtype_to_pads`), and `ceil_mode`'s extra high pad
  (`_ceil_pads`, `pooling.py:92-107`); a window reads padding as `-inf`
  (the integer minimum for integer inputs) for max and `0` for avg;
- `exclusive` divides each window's sum by the count of real elements in
  it, otherwise by the kernel's size;
- max pooling takes `max` over each window's flattened elements, which
  returns (and routes the gradient to) the first maximum in row-major
  window order, as JAX's pair reducer (`bv > av`) and its
  `select_and_scatter` do; `return_mask` gives that element's position in
  the flattened spatial axes, under NHWC too (`pooling.py:167-230`);
- adaptive pooling uses the JAX package's windows
  `[floor(i * in / out), ceil((i + 1) * in / out))`: an averaging matrix
  per axis for avg, a max per window for max (`pooling.py:233-300`);
- `lp_pool*` is `(k * avg(|x|^p))^(1/p)` with the non-exclusive average,
  and `max_unpool2d` scatters values to their flat indices.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import dispatch
from ...framework import dtype as dtype_mod
from ...ops._helpers import as_tensor
from .conv import _same_pads, _tuple_n

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "lp_pool1d", "lp_pool2d", "max_unpool2d"]


def _norm_pad(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return ((padding, padding),) * n
    padding = list(padding)
    if len(padding) == n:
        if all(isinstance(p, (list, tuple)) for p in padding):
            return tuple(tuple(int(x) for x in p) for p in padding)
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    raise ValueError(f"bad padding {padding}")


def _spatial_pads(shape, kernel, stride, padding, ceil_mode):
    """Per-side pads of the spatial axes (`shape` is theirs)."""
    if padding == "VALID":
        pads = [(0, 0)] * len(shape)
    elif padding == "SAME":
        pads = list(_same_pads(shape, kernel, stride, (1,) * len(shape)))
    else:
        pads = list(padding)
    if ceil_mode:
        out = []
        for s, k, st, (lo, hi) in zip(shape, kernel, stride, pads):
            padded = s + lo + hi
            rem = (padded - k) % st if padded >= k else 0
            out.append((lo, hi + ((st - rem) % st if rem else 0)))
        pads = out
    return pads


def _init(dtype, kind):
    if kind == "max":
        return float("-inf") if dtype_mod.is_inexact(dtype) \
            else int(torch.iinfo(dtype).min)
    return 0.0 if dtype_mod.is_inexact(dtype) else 0


def _windows(x, kernel, stride, pads, value):
    """[N, C, *spatial] -> [N, C, *out, prod(kernel)]: each window's
    elements in row-major order, padding read as `value`."""
    n = len(kernel)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if any(flat):
        x = torch.nn.functional.pad(x, flat, value=value)
    for i in range(n):
        x = x.unfold(2 + i, kernel[i], stride[i])
    return x.reshape(tuple(x.shape[:2 + n]) + (-1,))


def _channels_first(x, channel_last):
    return torch.movedim(x, -1, 1) if channel_last else x


def _back(y, channel_last):
    return torch.movedim(y, 1, -1) if channel_last else y


def _pool_fn(x, *, kernel, stride, padding, n, kind, ceil_mode, exclusive,
             data_format):
    channel_last = data_format.endswith("C")
    x = _channels_first(x, channel_last)
    pads = _spatial_pads(tuple(x.shape[2:]), kernel, stride, padding,
                         ceil_mode)
    if kind == "max":
        win = _windows(x, kernel, stride, pads, _init(x.dtype, "max"))
        return _back(win.max(dim=-1).values, channel_last)
    summed = _windows(x, kernel, stride, pads, _init(x.dtype, "avg")) \
        .sum(dim=-1)
    if exclusive:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = _windows(ones, kernel, stride, pads, 0).sum(dim=-1)
        return _back(summed / counts, channel_last)
    return _back(summed / int(np.prod(kernel)), channel_last)


for _n in (1, 2, 3):
    dispatch.register_op(f"pool{_n}d", (lambda n: lambda x, **kw: _pool_fn(
        x, n=n, **kw))(_n))


def _default_format(n):
    return {1: "NCW", 2: "NCHW", 3: "NCDHW"}[n]


def _pool(x, kernel_size, stride, padding, n, kind, ceil_mode=False,
          exclusive=True, data_format=None):
    x = as_tensor(x)
    kernel = _tuple_n(kernel_size, n)
    stride = _tuple_n(stride if stride is not None else kernel_size, n)
    return dispatch.apply(f"pool{n}d", [x],
                          {"kernel": kernel, "stride": stride,
                           "padding": _norm_pad(padding, n), "kind": kind,
                           "ceil_mode": bool(ceil_mode),
                           "exclusive": bool(exclusive),
                           "data_format": data_format
                           or _default_format(n)})


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", ceil_mode,
                 exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", ceil_mode,
                 exclusive, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", ceil_mode,
                 exclusive, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 1,
                                   ceil_mode)
    return _pool(x, kernel_size, stride, padding, 1, "max", ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 2,
                                   ceil_mode, data_format)
    return _pool(x, kernel_size, stride, padding, 2, "max", ceil_mode,
                 data_format=data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 3,
                                   ceil_mode, data_format)
    return _pool(x, kernel_size, stride, padding, 3, "max", ceil_mode,
                 data_format=data_format)


def _max_pool_mask_fn(x, *, kernel, stride, padding, n, ceil_mode,
                      channel_last=False):
    """(pooled, int32 flat spatial indices of each window's first max)."""
    x = _channels_first(x, channel_last)
    spatial = tuple(x.shape[2:])
    pads = _spatial_pads(spatial, kernel, stride, padding, ceil_mode)
    win = _windows(x, kernel, stride, pads, _init(x.dtype, "max"))
    out, arg = win.max(dim=-1)
    idx = torch.arange(int(np.prod(spatial)), dtype=torch.int32,
                       device=x.device).reshape((1, 1) + spatial)
    idx_win = _windows(idx, kernel, stride, pads, 0)
    idx_win = idx_win.expand(tuple(win.shape[:2]) + tuple(idx_win.shape[2:]))
    mask = torch.gather(idx_win, -1, arg.unsqueeze(-1)).squeeze(-1)
    return _back(out, channel_last), _back(mask, channel_last)


for _n in (1, 2, 3):
    dispatch.register_op(
        f"max_pool{_n}d_mask", (lambda n: lambda x, **kw: _max_pool_mask_fn(
            x, n=n, **kw))(_n), multi_out=True)


def _max_pool_with_mask(x, kernel_size, stride, padding, n, ceil_mode,
                        data_format=None):
    x = as_tensor(x)
    channel_last = bool(data_format) and data_format.endswith("C") \
        and not data_format.startswith("NC")
    return dispatch.apply(
        f"max_pool{n}d_mask", [x],
        {"kernel": _tuple_n(kernel_size, n),
         "stride": _tuple_n(stride if stride is not None else kernel_size,
                            n),
         "padding": _norm_pad(padding, n), "ceil_mode": bool(ceil_mode),
         "channel_last": channel_last})


# ---- adaptive pooling -------------------------------------------------------


def _bounds(in_s, out_s):
    starts = (np.arange(out_s) * in_s) // out_s
    ends = -(-((np.arange(out_s) + 1) * in_s) // out_s)
    return starts, ends


def _adaptive_pool_fn(x, *, output_size, n, kind):
    y = x
    for d in range(n):
        axis = 2 + d
        in_s, out_s = x.shape[axis], output_size[d]
        starts, ends = _bounds(in_s, out_s)
        if kind == "avg":
            m = np.zeros((in_s, out_s), dtype=np.float64)
            for i, (s, e) in enumerate(zip(starts, ends)):
                m[s:e, i] = 1.0 / (e - s)
            mat = torch.from_numpy(m).to(device=x.device, dtype=x.dtype)
            y = torch.movedim(torch.tensordot(y, mat, dims=([axis], [0])),
                              -1, axis)
        else:
            # `amax` shares a tie's gradient as `jnp.max` does
            y = torch.cat([y.narrow(axis, int(s), int(e - s)).amax(
                dim=axis, keepdim=True) for s, e in zip(starts, ends)],
                dim=axis)
    return y


for _n in (1, 2, 3):
    for _kind in ("avg", "max"):
        dispatch.register_op(
            f"adaptive_{_kind}_pool{_n}d",
            (lambda n, kind: lambda x, **kw: _adaptive_pool_fn(
                x, n=n, kind=kind, **kw))(_n, _kind))


def _adaptive(x, output_size, n, kind):
    x = as_tensor(x)
    if isinstance(output_size, (list, tuple)):
        os_ = tuple(int(x.shape[2 + i]) if v is None else int(v)
                    for i, v in enumerate(output_size))
    else:
        os_ = (int(output_size),) * n
    return dispatch.apply(f"adaptive_{kind}_pool{n}d", [x],
                          {"output_size": os_})


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max")


def _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode, n,
             data_format=None):
    from ...ops import math as math_ops

    p = float(norm_type)
    xp = math_ops.pow(as_tensor(x).abs(), p)
    pooled = _pool(xp, kernel_size, stride, padding, n, "avg", ceil_mode,
                   exclusive=False, data_format=data_format)
    k = np.prod(_tuple_n(kernel_size, n))
    return math_ops.pow(pooled * float(k), 1.0 / p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode, 1)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode, 2,
                    data_format)


def _unpool_fn(x, indices, *, out_sz):
    """Values scattered to their flat indices within each (n, c) plane."""
    n, c = x.shape[:2]
    flat = x.new_zeros((n, c, int(np.prod(out_sz))))
    flat = flat.scatter(2, indices.reshape(n, c, -1).long(),
                        x.reshape(n, c, -1))
    return flat.reshape((n, c) + tuple(out_sz))


dispatch.register_op("max_unpool2d", lambda x, idx, *, output_size:
                     _unpool_fn(x, idx, out_sz=output_size))


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    x, indices = as_tensor(x), as_tensor(indices)
    kernel = _tuple_n(kernel_size, 2)
    stride = _tuple_n(stride if stride is not None else kernel_size, 2)
    pad = _tuple_n(padding, 2)
    if output_size is None:
        h, w = x.shape[2], x.shape[3]
        output_size = ((h - 1) * stride[0] - 2 * pad[0] + kernel[0],
                       (w - 1) * stride[1] - 2 * pad[1] + kernel[1])
    else:
        output_size = tuple(int(v) for v in output_size)[-2:]
    return dispatch.apply("max_unpool2d", [x, indices],
                          {"output_size": tuple(output_size)})
