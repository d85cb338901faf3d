"""The common functionals on eager Tensors: the port of
`paddle_tpu/nn/functional/common.py`, with `pairwise_distance`
(`nn/functional/extended.py:276`), which the losses call.

`linear` is a plain `torch.matmul` (the JAX package computes it outside
any Pallas kernel). `dropout` draws its mask as the JAX package does:
`jax.random.bernoulli(key, 1 - p, shape)` on a key from the shared
generator (`framework/random.py`, `next_key`), which is
`uniform(key, shape, float64) < 1 - p` under the JAX package's
`jax_enable_x64`, with the port's threefry bits, so the same seed drops
the same elements in both packages. The key is a tensor input of the op
(its two uint32 words in an int64 tensor), not an attribute: a lazy
region replayed as a CUDA graph reads each call's key, and draws a new
mask every time. `dropout2d` / `dropout3d` drop whole channels through
its `axis`, and `alpha_dropout` draws the same bits.

The rest follow the JAX package's formulas, not torch's functions where
the two differ:
- `pad`: `jnp.pad`'s modes (`reflect`, `edge`, `wrap`) as numpy's own
  index pattern gathered along each axis, and a constant pad;
- `interpolate` (`common.py:264-350`): nearest by index, linear and area
  as products with the JAX package's interpolation matrices (built in
  float64 on the host, in the input's dtype), `align_mode` accepted and
  ignored; bicubic is `jax.image.resize(method="cubic")`'s: the Keys
  kernel with a = -0.5 on half-pixel centres, antialiased (the kernel
  widened by the inverse scale) when it shrinks, weights normalized per
  output;
- `unfold` pads its four sides first and orders the channels
  `(c, kh, kw)`; `fold` sums each kernel offset's columns back.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...framework import random as random_mod
from ...ops._helpers import as_tensor

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "pad", "interpolate", "upsample", "unfold",
           "fold", "bilinear", "cosine_similarity", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "label_smooth",
           "class_center_sample", "glu", "pairwise_distance"]


def _linear_fn(x, w, b=None):
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


dispatch.register_op("linear", _linear_fn)
dispatch.register_op("linear_nobias", lambda x, w: _linear_fn(x, w))


def linear(x, weight, bias=None, name=None):
    """`x @ weight + bias`, weight `[in, out]`."""
    x, weight = as_tensor(x), as_tensor(weight)
    if bias is None:
        return dispatch.apply("linear_nobias", [x, weight])
    return dispatch.apply("linear", [x, weight, as_tensor(bias)])


class _Embedding(torch.autograd.Function):
    """Rows of `w` at `ids`, with a deterministic backward: the rows'
    cotangents summed per id by `index_put_(accumulate=True)` (a sort on
    CUDA, no atomics) in float32, or float64 for a float64 `w`, then cast
    to w's dtype. torch's own
    embedding backward adds duplicate ids in a varying order on the card,
    so two runs of one step (eager and a lazy replay) could differ in
    the last bits."""

    @staticmethod
    def forward(ctx, ids, w):
        ctx.save_for_backward(ids)
        ctx.w_shape, ctx.w_dtype = tuple(w.shape), w.dtype
        return torch.nn.functional.embedding(ids, w)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        acc = torch.promote_types(ctx.w_dtype, torch.float32)
        gw = torch.zeros(ctx.w_shape, dtype=acc, device=g.device)
        gw.index_put_((ids.reshape(-1),),
                      g.reshape(-1, ctx.w_shape[-1]).to(acc),
                      accumulate=True)
        return None, gw.to(ctx.w_dtype)


def _embedding_fn(ids, w, *, padding_idx):
    out = _Embedding.apply(ids, w)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


dispatch.register_op("embedding", _embedding_fn)


class _SparseEmbedding(torch.autograd.Function):
    """Rows of `w` at `ids` whose backward gives the weight a
    `SelectedRows` (JAX's `_SparseEmbeddingGradNode`): rows the ids as
    int32, values the arriving cotangent rows (padding rows zeroed,
    kept), accumulated beside the leaf `owner` (`Tensor._sr`, later
    lookups concatenated after earlier ones); the dense `[V, H]` gradient
    is never built. Inside `paddle.grad`, or for a leaf with hooks, torch
    gets the dense gradient instead."""

    @staticmethod
    def forward(ctx, ids, w, owner, padding_idx):
        ctx.save_for_backward(ids)
        ctx.owner, ctx.height = owner, int(w.shape[0])
        ctx.padding_idx, ctx.w_dtype = padding_idx, w.dtype
        return _embedding_fn(ids, w, padding_idx=padding_idx)

    @staticmethod
    def backward(ctx, g):
        from ...core import autograd as autograd_mod
        from ...core.selected_rows import SelectedRows

        ids, = ctx.saved_tensors
        rows = ids.reshape(-1).to(torch.int32)
        vals = g.reshape(rows.shape[0], g.shape[-1])
        if ctx.padding_idx is not None:
            vals = torch.where((rows == ctx.padding_idx)[:, None],
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device), vals)
        sr = SelectedRows(rows, vals, ctx.height)
        leaf = ctx.owner._data
        if autograd_mod.sparse_densified() or leaf._backward_hooks:
            return None, sr.to_dense().to(ctx.w_dtype), None, None
        prev = ctx.owner._sr
        ctx.owner._sr = sr if prev is None else prev.concat(sr)
        return None, None, None, None


dispatch.register_op("embedding_sparse",
                     lambda ids, w, *, padding_idx, owner:
                     _SparseEmbedding.apply(ids, w, owner, padding_idx))


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids `x`; ids equal to `padding_idx` give
    zeros and no gradient. `sparse=True` gives a leaf weight a
    `SelectedRows` gradient (JAX's `use_sparse` rule: a leaf that
    requires grad, with grad enabled); any other weight takes the dense
    path."""
    x, weight = as_tensor(x), as_tensor(weight)
    if padding_idx is not None:
        padding_idx = int(padding_idx)
        if padding_idx < 0:
            padding_idx += int(weight.shape[0])
    if sparse and torch.is_grad_enabled() and not weight.stop_gradient \
            and weight.is_leaf:
        return dispatch.apply("embedding_sparse", [x, weight],
                              {"padding_idx": padding_idx, "owner": weight})
    return dispatch.apply("embedding", [x, weight],
                          {"padding_idx": padding_idx})


def _dropout_fn(x, key, *, p, mode, axis):
    if axis is None:
        mask_shape = tuple(x.shape)
    else:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        mask_shape = tuple(s if i in axes else 1
                           for i, s in enumerate(x.shape))
    # uniform(key, shape, float64, 0, 1) is its unit floats exactly
    u = random_mod._unit_floats(key, mask_shape, torch.float64, x.device)
    keep = u < 1.0 - p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        scale = 1.0 / (1.0 - p) if p < 1.0 else 0.0
        # the scale in x's dtype (as JAX's weak-typed scalar), filled on
        # x's device: no host copy, so a CUDA graph can capture the op
        return torch.where(keep, x * torch.full((), scale, dtype=x.dtype,
                                                device=x.device), zero)
    # downscale_in_infer: training multiplies by the mask only
    return torch.where(keep, x, zero)


dispatch.register_op("dropout", _dropout_fn)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    x = as_tensor(x)
    p = float(p)
    if not training:
        if mode == "downscale_in_infer":
            return x * (1.0 - p)
        return x
    if p == 0.0:
        return x
    if axis is not None and not isinstance(axis, int):
        axis = tuple(int(a) for a in axis)
    key = torch.tensor(random_mod.next_key(), dtype=torch.int64,
                       device=x.place.torch_device)
    return dispatch.apply("dropout", [x, key], {"p": p, "mode": mode,
                                                "axis": axis})


def _key_tensor(x):
    """A fresh key of the shared generator as an op input on x's
    device."""
    return torch.tensor(random_mod.next_key(), dtype=torch.int64,
                        device=x.place.torch_device)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=axis, training=training)


# SELU's constants
_ALPHA = 1.6732632423543772
_SCALE = 1.0507009873554805


def _alpha_dropout_fn(x, key, *, p, per_feature=False):
    """`jax.random.bernoulli(key, 1 - p, shape)` keeps; dropped elements
    take SELU's negative saturation, then the affine map that keeps the
    mean and variance. `per_feature` draws one bit per (N, C)."""
    alpha_p = -_ALPHA * _SCALE
    shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2) if per_feature \
        else tuple(x.shape)
    keep = random_mod._unit_floats(key, shape, torch.float64,
                                   x.device) < 1.0 - p
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * alpha_p * p
    y = torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                        device=x.device))
    return (a * y + b).to(x.dtype)


dispatch.register_op("alpha_dropout", _alpha_dropout_fn)


def alpha_dropout(x, p=0.5, training=True, name=None):
    x = as_tensor(x)
    if not training or p == 0.0:
        return x
    return dispatch.apply("alpha_dropout", [x, _key_tensor(x)],
                          {"p": float(p)})


# ---- pad --------------------------------------------------------------------


def _pad_fn(x, *, pad, mode, value, data_format):
    nd = x.dim()
    if len(pad) == 2 * nd:
        # the full form: per-axis pairs from axis 0
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # the partial form pads the trailing spatial axes, innermost
        # first ([w_lo, w_hi, h_lo, h_hi, ...])
        n_spatial = len(pad) // 2
        widths = [(0, 0)] * nd
        if data_format and data_format.endswith("C"):
            spatial_dims = list(range(1, 1 + n_spatial))
        else:
            spatial_dims = list(range(nd - n_spatial, nd))
        for i, d in enumerate(reversed(spatial_dims)):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, value=value)
    np_mode = {"reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}[mode]
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, d, torch.from_numpy(idx).to(x.device))
    return x


dispatch.register_op("nn_pad", _pad_fn)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None,
        pad_from_left_axis=False):
    x = as_tensor(x)
    if isinstance(pad, Tensor):
        pad = [int(v) for v in pad.numpy().tolist()]
    return dispatch.apply("nn_pad", [x],
                          {"pad": tuple(int(v) for v in pad), "mode": mode,
                           "value": float(value),
                           "data_format": data_format})


# ---- interpolate / upsample -------------------------------------------------


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _cubic_matrix(in_s, out_s):
    """`jax.image.scale`'s `compute_weight_mat` for the Keys kernel,
    antialiased, [in, out], float64."""
    inv_scale = in_s / out_s
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_s) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample_f[None, :] - np.arange(in_s)[:, None])
                    / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_s - 0.5)
    return np.where(inside[None, :], w, 0)


def _interp_matrix(mode, in_s, out_s, align_corners):
    """The JAX package's [in, out] matrix of one axis (float64)."""
    m = np.zeros((in_s, out_s))
    if mode == "area":
        starts = (np.arange(out_s) * in_s) // out_s
        ends = -(-((np.arange(out_s) + 1) * in_s) // out_s)
        for i, (s, e) in enumerate(zip(starts, ends)):
            m[s:e, i] = 1.0 / (e - s)
        return m
    if align_corners and out_s > 1:
        src = np.arange(out_s) * (in_s - 1) / (out_s - 1)
    else:
        src = (np.arange(out_s) + 0.5) * in_s / out_s - 0.5
    src = np.clip(src, 0, in_s - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_s - 1)
    w1 = src - i0
    for i in range(out_s):
        m[i0[i], i] += 1 - w1[i]
        m[i1[i], i] += w1[i]
    return m


def _interp_fn(x, *, size, mode, align_corners, data_format):
    channel_last = data_format.endswith("C") \
        and not data_format.startswith("NC")
    nd = x.dim() - 2
    axes = list(range(1, 1 + nd)) if channel_last else list(range(2, 2 + nd))
    y = x
    for ax, out_s in zip(axes, size):
        in_s = x.shape[ax]
        if mode == "nearest":
            if align_corners and out_s > 1:
                src = np.round(np.arange(out_s) * (in_s - 1) / (out_s - 1))
            else:
                src = np.floor(np.arange(out_s) * in_s / out_s)
            y = torch.index_select(y, ax, torch.from_numpy(
                src.astype(np.int64)).to(x.device))
            continue
        if mode == "bicubic":
            if in_s == out_s:       # jax.image.resize leaves such axes
                continue
            m = _cubic_matrix(in_s, out_s)
        else:
            m = _interp_matrix(mode, in_s, out_s, align_corners)
        mat = torch.from_numpy(m).to(device=x.device, dtype=x.dtype)
        y = torch.movedim(torch.tensordot(y, mat, dims=([ax], [0])), -1, ax)
    return y


dispatch.register_op("interpolate", _interp_fn)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format=None,
                name=None):
    x = as_tensor(x)
    nd = x.ndim - 2
    if data_format is None:
        data_format = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd]
    channel_last = data_format.endswith("C")
    spatial = x.shape[1:-1] if channel_last else x.shape[2:]
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size / scale_factor must be set")
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * nd
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    if isinstance(size, Tensor):
        size = [int(v) for v in size.numpy().tolist()]
    elif isinstance(size, (int, np.integer)):
        size = [int(size)] * nd
    size = tuple(int(s) for s in size)
    return dispatch.apply("interpolate", [x],
                          {"size": size, "mode": mode,
                           "align_corners": bool(align_corners),
                           "data_format": data_format})


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format=None, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format, name)


# ---- unfold / fold ----------------------------------------------------------


def _unfold_fn(x, *, kernel_sizes, strides, paddings, dilations):
    ph0, pw0, ph1, pw1 = paddings
    x = torch.nn.functional.pad(x, (pw0, pw1, ph0, ph1))
    return torch.nn.functional.unfold(x, kernel_sizes, dilation=dilations,
                                      stride=strides)


dispatch.register_op("unfold", _unfold_fn)


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _four(p):
    p = _pair(p)
    return (p[0], p[1], p[0], p[1]) if len(p) == 2 else p


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return dispatch.apply("unfold", [as_tensor(x)],
                          {"kernel_sizes": _pair(kernel_sizes),
                           "strides": _pair(strides),
                           "paddings": _four(paddings),
                           "dilations": _pair(dilations)})


def _fold_fn(x, *, output_sizes, kernel_sizes, strides, paddings,
             dilations):
    n, ckk, _ = x.shape
    kh, kw = kernel_sizes
    c = ckk // (kh * kw)
    oh, ow = output_sizes
    sh, sw = strides
    ph0, pw0, ph1, pw1 = paddings
    dh, dw = dilations
    ph, pw = oh + ph0 + ph1, ow + pw0 + pw1
    out_h = (ph - (dh * (kh - 1) + 1)) // sh + 1
    out_w = (pw - (dw * (kw - 1) + 1)) // sw + 1
    cols = x.reshape(n, c, kh, kw, out_h, out_w)
    out = x.new_zeros((n, c, ph, pw))
    for i in range(kh):
        for j in range(kw):
            hi, wj = i * dh, j * dw
            out[:, :, hi:hi + out_h * sh:sh, wj:wj + out_w * sw:sw] += \
                cols[:, :, i, j]
    return out[:, :, ph0:ph0 + oh, pw0:pw0 + ow]


dispatch.register_op("fold", _fold_fn)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    return dispatch.apply("fold", [as_tensor(x)],
                          {"output_sizes": _pair(output_sizes),
                           "kernel_sizes": _pair(kernel_sizes),
                           "strides": _pair(strides),
                           "paddings": _four(paddings),
                           "dilations": _pair(dilations)})


# ---- misc -------------------------------------------------------------------


def _bilinear_fn(x1, x2, w, b=None):
    y = torch.einsum("bi,oij,bj->bo", x1, w, x2)
    if b is not None:
        y = y + b
    return y


dispatch.register_op("bilinear", _bilinear_fn)
dispatch.register_op("bilinear_nobias", lambda x1, x2, w: _bilinear_fn(
    x1, x2, w))


def bilinear(x1, x2, weight, bias=None, name=None):
    """`x1 [B, in1]`, `x2 [B, in2]`, weight `[out, in1, in2]`."""
    if bias is None:
        return dispatch.apply("bilinear_nobias", [as_tensor(x1),
                                                  as_tensor(x2),
                                                  as_tensor(weight)])
    return dispatch.apply("bilinear", [as_tensor(x1), as_tensor(x2),
                                       as_tensor(weight), as_tensor(bias)])


def _pixel_shuffle_fn(x, *, upscale_factor, data_format):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


dispatch.register_op("pixel_shuffle", _pixel_shuffle_fn)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return dispatch.apply("pixel_shuffle", [as_tensor(x)],
                          {"upscale_factor": int(upscale_factor),
                           "data_format": data_format})


def _pixel_unshuffle_fn(x, *, downscale_factor, data_format):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


dispatch.register_op("pixel_unshuffle", _pixel_unshuffle_fn)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return dispatch.apply("pixel_unshuffle", [as_tensor(x)],
                          {"downscale_factor": int(downscale_factor),
                           "data_format": data_format})


def _channel_shuffle_fn(x, *, groups, data_format):
    n = x.shape[0]
    if data_format == "NCHW":
        c, h, w = x.shape[1:]
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    h, w, c = x.shape[1:]
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


dispatch.register_op("channel_shuffle", _channel_shuffle_fn)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return dispatch.apply("channel_shuffle", [as_tensor(x)],
                          {"groups": int(groups),
                           "data_format": data_format})


def _label_smooth_fn(label, prior_dist=None, *, epsilon):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


dispatch.register_op("label_smooth", _label_smooth_fn)
dispatch.register_op("label_smooth_prior", _label_smooth_fn)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    label = as_tensor(label)
    if prior_dist is None:
        return dispatch.apply("label_smooth", [label],
                              {"epsilon": float(epsilon)})
    return dispatch.apply("label_smooth_prior",
                          [label, as_tensor(prior_dist)],
                          {"epsilon": float(epsilon)})


def glu(x, axis=-1, name=None):
    from ...ops import activation as act_ops

    return act_ops.glu(x, axis=axis)


def class_center_sample(label, num_classes, num_samples, group=None):
    raise NotImplementedError(
        "class_center_sample requires the distributed margin-loss path; "
        "use margin_cross_entropy instead")


def _cos_sim_fn(x1, x2, *, axis, eps):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


dispatch.register_op("cosine_similarity", _cos_sim_fn)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return dispatch.apply("cosine_similarity", [as_tensor(x1), as_tensor(x2)],
                          {"axis": int(axis), "eps": float(eps)})


dispatch.register_op("pairwise_distance", lambda x, y, *, p, eps, keepdim:
                     torch.linalg.vector_norm(
                         (x - y + eps).to(torch.float32), ord=p, dim=-1,
                         keepdim=keepdim).to(x.dtype))


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """`||x - y + eps||_p` over the last axis, in f32."""
    return dispatch.apply("pairwise_distance", [as_tensor(x), as_tensor(y)],
                          {"p": float(p), "eps": float(epsilon),
                           "keepdim": bool(keepdim)})
