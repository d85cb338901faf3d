"""The rest of `paddle.nn.functional`: the port of
`paddle_tpu/nn/functional/extended.py`, op for op.

- `affine_grid` / `grid_sample` (bilinear or nearest, zeros / border /
  reflection padding) and `temporal_shift` are the JAX package's gather
  and roll formulas; `zeropad2d` is `pad`'s constant mode;
- `sequence_mask` and `gather_tree` (the beam backtrace, walked from the
  last step as the JAX package's reversed `lax.scan` walks it);
- the random ones draw from the shared generator with the JAX package's
  bits: `gumbel_softmax` `uniform(key, shape, float32, 1e-10, 1)`,
  `feature_alpha_dropout` one Bernoulli bit per (N, C), and the
  fractional pools' `u` a float64 `uniform(key, ())` when `random_u` is
  not given;
- `max_unpool1d/3d` scatter to flat indices; `fractional_max_pool2d/3d`
  take the max over Graham's pseudo-random windows (`return_mask` raises,
  as in the JAX package);
- the in-place activations (`relu_`, `elu_`, ...) compute out of place
  and rebind, as `ops`' in-place table does;
- `pairwise_distance` is re-exported from `common`.
"""
from __future__ import annotations

import math

import torch

from ...core import dispatch
from ...framework import dtype as dtype_mod
from ...framework import random as random_mod
from ...ops._helpers import as_tensor, inplace_rebind
from .common import _alpha_dropout_fn, _key_tensor
from .common import pad as _pad
from .common import pairwise_distance
from .pooling import _unpool_fn

__all__ = [
    "affine_grid", "grid_sample", "temporal_shift", "zeropad2d",
    "sequence_mask", "gather_tree", "gumbel_softmax", "pairwise_distance",
    "feature_alpha_dropout", "max_unpool1d", "max_unpool3d",
    "fractional_max_pool2d", "fractional_max_pool3d",
    "relu_", "elu_", "leaky_relu_", "hardtanh_", "softmax_", "tanh_",
    "thresholded_relu_",
]


def _inplace(base):
    def op(x, *args, **kwargs):
        return inplace_rebind(x, base(x, *args, **kwargs))

    op.__name__ = base.__name__ + "_"
    return op


def _bind_inplace_activations():
    from ...ops import activation as A
    from ...ops import math as M

    g = globals()
    for name in ("relu", "elu", "leaky_relu", "hardtanh", "softmax", "tanh",
                 "thresholded_relu"):
        g[name + "_"] = _inplace(getattr(A, name, None) or getattr(M, name))


# ---- spatial -----------------------------------------------------------------


def _linspace64(lo, hi, m, device):
    return torch.linspace(lo, hi, m, dtype=torch.float64, device=device)


def _affine_grid_fn(theta, *, sizes, align):
    _, _, h, w = sizes

    def axis_coords(m):
        if align:
            return _linspace64(-1.0, 1.0, m, theta.device)
        step = 2.0 / m
        return _linspace64(-1.0 + step / 2, 1.0 - step / 2, m, theta.device)

    gy, gx = torch.meshgrid(axis_coords(h), axis_coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("hwk,njk->nhwj", base.to(theta.dtype), theta)


dispatch.register_op("affine_grid", _affine_grid_fn)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The sampling grid `[N, H, W, 2]` of batched 2 x 3 affine
    matrices."""
    return dispatch.apply("affine_grid", [as_tensor(theta)],
                          {"sizes": tuple(int(s) for s in out_shape),
                           "align": bool(align_corners)})


def _grid_sample_fn(x, grid, *, mode, padding_mode, align):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def unnorm(g, size):
        if align:
            return (g + 1) * (size - 1) / 2.0
        return ((g + 1) * size - 1) / 2.0

    fx, fy = unnorm(gx, w), unnorm(gy, h)
    if padding_mode == "border":
        fx, fy = fx.clamp(0, w - 1), fy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        def reflect(f, size):
            if align:
                span = 2 * (size - 1)
                f = torch.remainder(f.abs(), span)
                return torch.where(f > size - 1, span - f, f)
            span = 2 * size
            f = torch.remainder(f + 0.5, span)
            f = torch.where(f > size, span - f, f) - 0.5
            return f.clamp(0, size - 1)

        fx, fy = reflect(fx, w), reflect(fy, h)
    b = torch.arange(n, device=x.device)[:, None, None]
    xl = x.permute(0, 2, 3, 1)                           # [N, H, W, C]

    def gather(ix, iy):
        inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        ixc = ix.clamp(0, w - 1).to(torch.int64)
        iyc = iy.clamp(0, h - 1).to(torch.int64)
        vals = xl[b, iyc, ixc]                           # [N, Ho, Wo, C]
        return torch.where(inside[..., None], vals,
                           torch.zeros((), dtype=vals.dtype,
                                       device=vals.device))

    if mode == "nearest":
        return gather(torch.round(fx), torch.round(fy)).permute(0, 3, 1, 2)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1, y0 + 1
    wa = (x1 - fx) * (y1 - fy)
    wb = (x1 - fx) * (fy - y0)
    wc = (fx - x0) * (y1 - fy)
    wd = (fx - x0) * (fy - y0)
    out = (gather(x0, y0) * wa[..., None] + gather(x0, y1) * wb[..., None]
           + gather(x1, y0) * wc[..., None] + gather(x1, y1) * wd[..., None])
    return out.permute(0, 3, 1, 2)                       # [N, C, Ho, Wo]


dispatch.register_op("grid_sample", _grid_sample_fn)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return dispatch.apply("grid_sample", [as_tensor(x), as_tensor(grid)],
                          {"mode": str(mode),
                           "padding_mode": str(padding_mode),
                           "align": bool(align_corners)})


def _temporal_shift_fn(x, *, seg, ratio, nchw):
    if not nchw:
        x = torch.movedim(x, -1, 1)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg, seg, c, h, w)
    fold = int(c * ratio)
    fwd = torch.roll(xr[:, :, :fold], 1, dims=1).clone()
    fwd[:, 0] = 0.0
    bwd = torch.roll(xr[:, :, fold:2 * fold], -1, dims=1).clone()
    bwd[:, -1] = 0.0
    out = torch.cat([fwd, bwd, xr[:, :, 2 * fold:]], dim=2)
    out = out.reshape(nt, c, h, w)
    return out if nchw else torch.movedim(out, 1, -1)


dispatch.register_op("temporal_shift", _temporal_shift_fn)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's channel shift across time segments."""
    return dispatch.apply("temporal_shift", [as_tensor(x)],
                          {"seg": int(seg_num), "ratio": float(shift_ratio),
                           "nchw": data_format == "NCHW"})


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return _pad(x, padding, mode="constant", value=0.0,
                data_format=data_format)


def _sequence_mask_fn(lens, *, maxlen, dt):
    rng = torch.arange(maxlen, device=lens.device)
    return (rng < lens[..., None]).to(dtype_mod.to_torch(dt))


dispatch.register_op("sequence_mask", _sequence_mask_fn)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """`mask[..., j] = j < x[...]`."""
    x = as_tensor(x)
    if maxlen is None:
        maxlen = int(x.numpy().max())
    return dispatch.apply("sequence_mask", [x],
                          {"maxlen": int(maxlen), "dt": str(dtype)})


def _gather_tree_fn(ids, parents):
    t, b, w = ids.shape
    binx = torch.arange(b, device=ids.device)[:, None]
    beam = torch.arange(w, device=ids.device)[None, :].expand(b, w)
    outs = [None] * t
    for step in range(t - 1, -1, -1):
        outs[step] = ids[step][binx, beam]
        beam = parents[step].to(torch.int64)[binx, beam]
    return torch.stack(outs)


dispatch.register_op("gather_tree", _gather_tree_fn)


def gather_tree(ids, parents, name=None):
    """The beam-search backtrace over `[T, B, W]` ids and parents."""
    return dispatch.apply("gather_tree", [as_tensor(ids),
                                          as_tensor(parents)])


def _gumbel_fn(x, key, *, temperature, hard, axis):
    u = random_mod.uniform(key, tuple(x.shape), torch.float32, 1e-10, 1.0,
                           x.device)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter(axis, idx, 1.0)
        # straight through: the one-hot forward, the soft backward
        y = (onehot - y).detach() + y
    return y


dispatch.register_op("gumbel_softmax", _gumbel_fn)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    x = as_tensor(x)
    return dispatch.apply("gumbel_softmax", [x, _key_tensor(x)],
                          {"temperature": float(temperature),
                           "hard": bool(hard), "axis": int(axis)})


dispatch.register_op("feature_alpha_dropout", lambda x, key, *, p:
                     _alpha_dropout_fn(x, key, p=p, per_feature=True))


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of whole channels."""
    x = as_tensor(x)
    if not training or p == 0.0:
        return x
    if not 0 <= p < 1:
        raise ValueError(f"p must be in [0, 1), got {p}")
    return dispatch.apply("feature_alpha_dropout", [x, _key_tensor(x)],
                          {"p": float(p)})


# ---- pooling -----------------------------------------------------------------


dispatch.register_op("max_unpool1d", lambda x, idx, *, out_l: _unpool_fn(
    x, idx, out_sz=(out_l,)))
dispatch.register_op("max_unpool3d", _unpool_fn)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    x, indices = as_tensor(x), as_tensor(indices)
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = k if stride is None else (
        stride if isinstance(stride, int) else stride[0])
    pd = padding if isinstance(padding, int) else padding[0]
    out_l = (x.shape[-1] - 1) * s - 2 * pd + k if output_size is None \
        else int(tuple(output_size)[-1])
    return dispatch.apply("max_unpool1d", [x, indices], {"out_l": out_l})


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    x, indices = as_tensor(x), as_tensor(indices)

    def tup(v):
        return (v,) * 3 if isinstance(v, int) else tuple(int(a) for a in v)

    k = tup(kernel_size)
    s = tup(stride if stride is not None else kernel_size)
    pd = tup(padding)
    if output_size is None:
        out_sz = tuple((m - 1) * st - 2 * p + kk for m, st, p, kk in
                       zip(x.shape[2:], s, pd, k))
    else:
        out_sz = tuple(int(v) for v in tuple(output_size)[-3:])
    return dispatch.apply("max_unpool3d", [x, indices], {"out_sz": out_sz})


def _fractional_bounds(in_size, out_size, u):
    """Graham's pseudo-random boundaries: b_i = ceil(a * (i + u)) - 1,
    windows [b_i, b_{i+1}) whose sizes differ by at most one."""
    alpha = in_size / out_size
    bounds = [0]
    for i in range(1, out_size):
        bounds.append(min(in_size - 1, int(math.ceil(alpha * (i + u))) - 1))
    bounds.append(in_size)
    return bounds


def _fractional_fn(x, *, bounds, ndim):
    slabs = x
    for d in range(ndim):
        b = bounds[d]
        ax = x.dim() - ndim + d
        slabs = torch.cat([slabs.narrow(ax, b[i], b[i + 1] - b[i]).amax(
            dim=ax, keepdim=True) for i in range(len(b) - 1)], dim=ax)
    return slabs


dispatch.register_op("fractional_max_pool2d", _fractional_fn)
dispatch.register_op("fractional_max_pool3d", _fractional_fn)


def _fractional_pool(x, output_size, random_u, ndim, return_mask):
    spatial = tuple(int(s) for s in x.shape[-ndim:])
    out_sz = (output_size,) * ndim if isinstance(output_size, int) \
        else tuple(int(v) for v in output_size)
    if return_mask:
        raise NotImplementedError(
            "fractional_max_pool(return_mask=True): the argmax mask is not "
            "implemented; use return_mask=False")
    if random_u is not None:
        u = float(random_u)
    else:
        # a fresh draw per call (`jax.random.uniform(key, ())`, float64)
        u = float(random_mod.uniform(random_mod.next_key(), (),
                                     torch.float64, 0.0, 1.0, "cpu"))
    bounds = tuple(tuple(_fractional_bounds(spatial[d], out_sz[d], u))
                   for d in range(ndim))
    return dispatch.apply(f"fractional_max_pool{ndim}d", [x],
                          {"bounds": bounds, "ndim": ndim})


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool(as_tensor(x), output_size, random_u, 2,
                            return_mask)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_pool(as_tensor(x), output_size, random_u, 3,
                            return_mask)


_bind_inplace_activations()
