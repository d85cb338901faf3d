"""Fused-op functional API: the port of
`paddle_tpu/incubate/nn/functional/` (reference
`python/paddle/incubate/nn/functional/`), the surface PaddleNLP builds a
fused Llama layer from (`fused_rms_norm`, `fused_rotary_position_embedding`,
`swiglu`, `fused_bias_act`, `block_multihead_attention`).

The functions are tensor-in, tensor-out like `torch.nn.functional`: each
runs on the device its inputs are on. Where the JAX package takes a
Pallas kernel when kernels are on (`_pallas_on`: f32 / bf16 / f16 inputs),
the port always takes the kernel module's route (`ops/kernels/rope.py`,
`bias_act.py`, `rms_norm.py`): the plain version on CPU tensors, the
hand-written kernel on CUDA tensors, which raises on an input the kernel
refuses. There is no kernels-enabled gate and no fallback. Other dtypes
take the plain composites, as in JAX.

Arguments the JAX package accepts and ignores (output quantization,
smoothing, beam offsets, pre-caches, masks no path applies) raise
NotImplementedError here when they are set: the port refuses such an
input rather than give another answer than the reference would.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....nn.functional.attention import NEG_INF
from ....nn.functional.norm import _rms_norm_fn
from ....ops import activation as _activation
from ....ops.kernels import bias_act as _ba
from ....ops.kernels import rms_norm as _rms
from ....ops.kernels import rope as _rope
from .decode_attention import (_refuse, blha_get_max_len,
                               block_multihead_attention,
                               masked_multihead_attention)

__all__ = ["fused_rms_norm", "fused_layer_norm",
           "fused_rotary_position_embedding", "swiglu", "fused_bias_act",
           "fused_linear", "fused_linear_activation",
           "variable_length_memory_efficient_attention",
           "masked_multihead_attention", "block_multihead_attention",
           "blha_get_max_len"]

def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kwargs):
    """Fused RMSNorm (+ optional pre-norm residual add), `__init__.py:52-90`:
    x + bias, then + residual, then normalise over axes
    `[begin_norm_axis:]` (flattened into one), then + `norm_bias`. Returns
    `(out, residual_out)` when a residual is passed. The RMSNorm kernel's
    route when its `supported()` holds (rank >= 2, f32 / bf16 / f16), the
    `/ sqrt` composite otherwise. The kernel route takes the weight in
    x's dtype only and raises on another, on either device: the JAX
    package's Pallas kernel refuses it too (it stores the f32 product of
    a 16-bit x and an f32 weight into an output of x's dtype)."""
    _refuse("fused_rms_norm", quant_scale=quant_scale != -1)
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    residual_out = x if residual is not None else None
    w = norm_weight
    axis = begin_norm_axis if begin_norm_axis >= 0 else \
        begin_norm_axis + x.dim()
    orig_shape = x.shape
    flatten = axis < x.dim() - 1
    flat = x
    if flatten:                 # flatten the normalised axes into one
        flat = x.reshape(*orig_shape[:axis], -1)
        w = w.reshape(-1)
    if _rms.supported(tuple(flat.shape), flat.dtype):
        if w.dtype != flat.dtype:
            raise ValueError(f"fused_rms_norm: the weight must be in x's "
                             f"dtype {flat.dtype}, got {w.dtype}")
        out = _rms.rms_norm(flat, w, float(epsilon))
    else:
        out = _rms_norm_fn(flat, w, float(epsilon))
    if norm_bias is not None:
        out = out + (norm_bias.reshape(-1) if flatten else norm_bias)
    if flatten:
        out = out.reshape(orig_shape)
    return (out, residual_out) if residual is not None else out


def _layer_norm_fn(x, w, b, epsilon):
    """`nn/functional/norm.py` `_ln_fn` over the last axis, in x's dtype."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + epsilon)
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None,
                     **kwargs):
    """Fused LayerNorm (+ residual), `__init__.py:93-122`: normalises over
    axes `[begin_norm_axis:]` with the reference's flattened 1-D weight
    convention; plain."""
    _refuse("fused_layer_norm",
            quant_scale=kwargs.get("quant_scale", -1) != -1)
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    residual_out = x if residual is not None else None
    axis = begin_norm_axis if begin_norm_axis >= 0 else \
        begin_norm_axis + x.dim()
    orig_shape = x.shape
    flatten = axis < x.dim() - 1
    flat, w, b = x, norm_weight, norm_bias
    if flatten:
        flat = x.reshape(*orig_shape[:axis], -1)
        w = None if w is None else w.reshape(-1)
        b = None if b is None else b.reshape(-1)
    out = _layer_norm_fn(flat, w, b, epsilon)
    if flatten:
        out = out.reshape(orig_shape)
    return (out, residual_out) if residual is not None else out


def _rope_generic_fn(x, cos, sin, neox, batched, offset):
    """`__init__.py:125-150`, plain: x `[B, S, H, D]`; cos/sin `[T, D/2]`
    (sliced at `offset`) or `[B, S, D/2]` (batched). `neox` rotates the
    adjacent pairs `(x[2i], x[2i+1])`, otherwise the halves
    `(x[i], x[i + D/2])`. f32 math, one rounding to x's dtype."""
    s_len = x.shape[1]
    if batched:
        c = cos[:, :, None, :].to(torch.float32)
        s = sin[:, :, None, :].to(torch.float32)
    else:
        c = cos[offset:offset + s_len][None, :, None, :].to(torch.float32)
        s = sin[offset:offset + s_len][None, :, None, :].to(torch.float32)
    xf = x.to(torch.float32)
    if neox:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(x.shape)
    else:
        d2 = x.shape[-1] // 2
        x1, x2 = xf[..., :d2], xf[..., d2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _rope_tables(d, t, base, dtype, device):
    """cos/sin `[t, d/2]` as `__init__.py:174-182` makes them: float64,
    rounded to `dtype` in one step (f16 through numpy, whose cast rounds
    once as JAX's does; torch's rounds through f32)."""
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    freqs = np.outer(np.arange(t, dtype=np.float64), inv)
    out = []
    for table in (np.cos(freqs), np.sin(freqs)):
        if dtype == torch.float16:
            table = table.astype(np.float16)
        out.append(torch.from_numpy(table).to(dtype).to(device))
    return out


def _take_rows(table, pid):
    """`jnp.take(table, pid, axis=0)`: negative ids count from the end,
    ids outside `[-T, T)` give NaN rows (its "fill" mode); no host sync
    and no device assert."""
    n = table.shape[0]
    pid = pid.to(device=table.device, dtype=torch.int64)
    pid = torch.where(pid < 0, pid + n, pid)
    valid = (pid >= 0) & (pid < n)
    rows = table[pid.clamp(0, max(n - 1, 0))]
    return torch.where(valid[..., None], rows,
                       torch.full_like(rows, float("nan")))


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0, offset=0):
    """`__init__.py:156-233`. q/k/v `[B, S, H, D]`: every tensor given is
    rotated. cos/sin `[T, D/2]`, or full-D tables (`[*, T, D]`, halved per
    layout: `[0::2]` for adjacent pairs, `[:D/2]` for halves); None
    generates them from `rotary_emb_base` in float64, in q's dtype.
    `position_ids [B, S]` gathers per-batch rows.
    `use_neox_rotary_style=True` rotates adjacent pairs
    `(x[2i], x[2i+1])`, False the halves `(x[i], x[i + D/2])`.

    The fused kernel (`ops/kernels/rope.py`) runs q and k together when
    the layout is halves, without `position_ids`, with a k of q's shape
    and a q its `supported()` takes; v (and everything else: adjacent
    pairs, gathered tables, GQA k) takes the plain rotation."""
    d = q.shape[-1]
    if cos is None or sin is None:
        t = max(q.shape[1] + offset, 1)
        if position_ids is not None:
            t = max(t, int(torch.as_tensor(position_ids).max()) + 1)
        cos, sin = _rope_tables(d, t, rotary_emb_base, q.dtype, q.device)
    if cos.dim() > 2:
        cos = cos.reshape(-1, cos.shape[-1])
        sin = sin.reshape(-1, sin.shape[-1])
    if cos.shape[-1] == d:
        if use_neox_rotary_style:
            cos, sin = cos[..., 0::2], sin[..., 0::2]
        else:
            cos, sin = cos[..., :d // 2], sin[..., :d // 2]
    batched = position_ids is not None
    if batched:
        pid = torch.as_tensor(position_ids)
        cos, sin = _take_rows(cos, pid), _take_rows(sin, pid)  # [B, S, D/2]

    tensors = [("q", q)] + [(n, t) for n, t in (("k", k), ("v", v))
                            if t is not None]
    use_kernel = (not use_neox_rotary_style and not batched
                  and _rope.supported(tuple(q.shape), q.dtype)
                  and k is not None and tuple(q.shape) == tuple(k.shape))
    outs = {}
    if use_kernel:
        outs["q"], outs["k"] = _rope.fused_rope(q, k, cos, sin, int(offset))
        if v is not None:
            outs["v"] = _rope_generic_fn(v, cos, sin, False, False,
                                         int(offset))
    else:
        for name, t in tensors:
            outs[name] = _rope_generic_fn(t, cos, sin,
                                          bool(use_neox_rotary_style),
                                          batched, int(offset))
    result = [outs[name] for name, _ in tensors]
    return result[0] if len(result) == 1 else tuple(result)


def swiglu(x, y=None, name=None):
    """`silu(x) * y`, or the halves of x's last axis when y is None
    (`__init__.py:236-246`): the kernel module's route for f32 / bf16 /
    f16 (`swiglu` for two tensors, `fused_bias_act(x, None, "swiglu")`
    packed), the plain composite otherwise."""
    if _ba.supported(x.dtype):
        return _ba.swiglu(x, y)
    return _activation.swiglu(x, y)


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None,
                   smooth=None, act_method="gelu", compute_dtype="default",
                   quant_scale=-1, quant_round_type=0, quant_max_bound=0,
                   quant_min_bound=0):
    """`act(x + bias)` over the last axis (`__init__.py:249-272`):
    act_method gelu (A-S erf), gelu_tanh, relu, silu / swish, sigmoid,
    identity, or swiglu / geglu over the two halves; an unknown one raises
    KeyError. The quantization and smoothing arguments raise
    NotImplementedError when set (JAX ignores them)."""
    _refuse("fused_bias_act", dequant_scales=dequant_scales is not None,
            shift=shift is not None, smooth=smooth is not None,
            compute_dtype=compute_dtype != "default",
            quant_scale=quant_scale != -1,
            quant_round_type=quant_round_type != 0,
            quant_max_bound=quant_max_bound != 0,
            quant_min_bound=quant_min_bound != 0)
    act = act_method.lower()
    if _ba.supported(x.dtype):
        return _ba.fused_bias_act(x, bias, act)
    if bias is None:
        bias = torch.zeros((x.shape[-1],), dtype=x.dtype, device=x.device)
    return _ba.bias_act_ref(x, bias, act)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """`x @ weight (+ bias)` with a paddle `[in, out]` weight (`[out, in]`
    with `transpose_weight`), `__init__.py:275-284`."""
    w = weight.t() if transpose_weight else weight
    y = torch.matmul(x, w)
    return y if bias is None else y + bias


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu"):
    """gemm, then `fused_bias_act(out, bias, activation)`
    (`__init__.py:287-295`)."""
    if trans_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if trans_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return fused_bias_act(torch.matmul(x, y), bias, act_method=activation)


def variable_length_memory_efficient_attention(query, key, value, seq_lens,
                                               kv_seq_lens, mask=None,
                                               scale=None, causal=False,
                                               pre_cache_length=0):
    """Varlen attention, `__init__.py:298-351`, plain: query/key/value
    `[B, H, S, D]`, seq_lens / kv_seq_lens `[B]` (or `[B, 1]`) valid
    lengths; f32 scores, masked to -1e30 outside the valid rows and
    columns (and, with `causal`, above the bottom-right-aligned diagonal),
    a boolean mask selects and a float mask adds; probabilities in q's
    dtype before the product with V. A row with no valid column averages
    V, as in JAX."""
    _refuse("variable_length_memory_efficient_attention",
            pre_cache_length=pre_cache_length != 0)
    q, k, v = query, key, value
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    sq, skv = q.shape[2], k.shape[2]
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    dev = q.device
    sl = torch.as_tensor(seq_lens, device=dev).reshape(-1, 1, 1)
    kl = torch.as_tensor(kv_seq_lens, device=dev).reshape(-1, 1, 1)
    qpos = torch.arange(sq, device=dev)
    kpos = torch.arange(skv, device=dev)
    valid = (qpos[:, None] < sl) & (kpos[None, :] < kl)     # [B, Sq, Skv]
    valid = valid[:, None]
    if causal:
        valid = valid & (qpos[:, None] + (skv - sq) >= kpos[None, :])
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores,
                                 torch.full_like(scores, NEG_INF))
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return probs @ v
