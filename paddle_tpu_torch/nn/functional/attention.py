"""`scaled_dot_product_attention` in paddle's `[B, S, H, D]` layout,
routed as `paddle_tpu/nn/functional/attention.py:94-118` and
`flash_attention.maybe_flash` route it (`_route`): the flash kernels
(`ops/kernels/flash_attention.py`) when their `supported()` holds and not
(causal with Sq != Sk); the plain composite `_sdpa_fn` for what the JAX
rule itself refuses (`jax_supported()`: D > 256, causal with Sq != Sk)
and for CPU tensors. A CUDA tensor that the JAX rule gives to its kernel
and the port's kernels do not take (D of 144-256, or D not a multiple of
16) raises `NotImplementedError`: it never runs the plain attention
where the JAX package runs its kernel. Masks are not ported yet: the
model attends with `is_causal` alone.

Eager `Tensor` inputs go through `dispatch.apply("sdpa", ...)` to the
same routes and come back as a `Tensor`; plain `torch.Tensor` inputs
give a plain `torch.Tensor`."""
from __future__ import annotations

import math

import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...ops._helpers import as_tensor
from ...ops.kernels import flash_attention as _flash

__all__ = ["scaled_dot_product_attention"]

NEG_INF = -1e30


def _sdpa_fn(q, k, v, causal, scale=None):
    """`attention.py:43-75`: f32 scores, a -1e30 mask (causal aligned to
    the bottom right), GQA by repeating K/V heads, probabilities cast to
    q's dtype before the product with V."""
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    sq, skv = q.shape[2], k.shape[2]
    if causal:
        keep = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        scores = scores.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ v).transpose(1, 2)


def _route(q_shape, k_shape, dtype, is_causal, device_type) -> str:
    """"flash" (the kernels; their plain versions on CPU tensors),
    "plain" (`_sdpa_fn`) or "raise". Inside a capture (`jit.to_static`,
    `jit.save`) a shape the JAX rule gives to its kernel takes "flash"
    whatever the capture's device: the recorded op then runs the plain
    version on CPU tensors and, on CUDA tensors, the kernel or its typed
    refusal (`ValueError`), never the plain attention."""
    if is_causal and q_shape[1] != k_shape[1]:
        return "plain"
    if _flash.supported(q_shape, k_shape, dtype):
        return "flash"
    if _flash.jax_supported(q_shape, k_shape, dtype):
        if torch.compiler.is_exporting():
            return "flash"
        if device_type == "cuda":
            return "raise"
    return "plain"


def _sdpa(query, key, value, *, is_causal):
    route = _route(tuple(query.shape), tuple(key.shape), query.dtype,
                   is_causal, query.device.type)
    if route == "flash":
        return _flash.flash_attention_bshd(query, key, value,
                                           causal=is_causal)
    if route == "raise":
        raise NotImplementedError(
            f"scaled_dot_product_attention: head dim {query.shape[-1]} is "
            f"not taken by the port's flash kernels (D a multiple of 16, at "
            f"most {_flash.MAX_HEAD_DIM}), and the JAX package runs its "
            f"kernel there (D <= 256)")
    return _sdpa_fn(query, key, value, is_causal)


dispatch.register_op("sdpa", _sdpa)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False):
    """q `[B, Sq, H, D]`, k/v `[B, Sk, KVH, D]` -> `[B, Sq, H, D]`."""
    if attn_mask is not None:
        raise NotImplementedError("scaled_dot_product_attention: attn_mask "
                                  "is not ported yet")
    if any(isinstance(t, Tensor) for t in (query, key, value)):
        return dispatch.apply("sdpa", [as_tensor(t) for t in (query, key,
                                                                value)],
                              {"is_causal": bool(is_causal)})
    return _sdpa(query, key, value, is_causal=is_causal)
