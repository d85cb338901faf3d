"""`linear`, `embedding`, `dropout` and `cosine_similarity` on eager
Tensors: the port of `paddle_tpu/nn/functional/common.py:29-175` and
`:460-474`, with `pairwise_distance` (`nn/functional/extended.py:276`),
which the losses call.

`linear` is a plain `torch.matmul` (the JAX package computes it outside
any Pallas kernel). `dropout` draws its mask as the JAX package does:
`jax.random.bernoulli(key, 1 - p, shape)` on a key from the shared
generator (`framework/random.py`, `next_key`), which is
`uniform(key, shape, float64) < 1 - p` under the JAX package's
`jax_enable_x64`, with the port's threefry bits, so the same seed drops
the same elements in both packages. The key is a tensor input of the op
(its two uint32 words in an int64 tensor), not an attribute: a lazy
region replayed as a CUDA graph reads each call's key, and draws a new
mask every time.
"""
from __future__ import annotations

import torch

from ...core import dispatch
from ...framework import random as random_mod
from ...ops._helpers import as_tensor

__all__ = ["linear", "embedding", "dropout", "cosine_similarity",
           "pairwise_distance"]


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


def _embedding_fn(ids, w, *, padding_idx):
    out = torch.nn.functional.embedding(ids, w)
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


dispatch.register_op("embedding", _embedding_fn)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids `x`; ids equal to `padding_idx` give
    zeros and no gradient. `sparse=True` (a SelectedRows gradient) is not
    ported yet."""
    if sparse:
        raise NotImplementedError("embedding(sparse=True): SelectedRows "
                                  "gradients are not ported yet")
    x, weight = as_tensor(x), as_tensor(weight)
    if padding_idx is not None:
        padding_idx = int(padding_idx)
        if padding_idx < 0:
            padding_idx += int(weight.shape[0])
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
