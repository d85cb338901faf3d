"""Weight-only quantization for the serving engine (the port's slice of
`paddle_tpu/nn/quant/__init__.py`): per-output-channel absmax
quantization to int8 / int4 / fp8-e4m3, the split-half int4 packing,
and `dequant_matmul`, which runs the weight-only gemm kernels of
`ops/kernels/quant_matmul.py`.

Layouts are the JAX package's: a quantized weight is `[N, K]` (the
transpose of the engine's `[K, N]` projection) with an `[N]` f32 scale;
int4 packs two values per byte into `[N, K/2]`.
"""
from __future__ import annotations

import torch

from ..ops.kernels import quant_matmul as qm

__all__ = ["quantize_with_scales", "per_channel_quantize", "pack_int4",
           "unpack_int4", "dequant_matmul"]

_FP8_MAX = 448.0   # largest finite float8_e4m3fn


def _channel_scales(w: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-channel `absmax / qmax` over the last axis, in f32. The divisor
    is a tensor: CUDA divides by a host scalar as a multiply by its
    reciprocal, one ulp off the true division the CPU (and JAX) do."""
    amax = w.abs().amax(dim=-1)
    return amax / amax.new_full((), float(qmax))


def quantize_with_scales(w: torch.Tensor, scales: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """Round (half to even) and clip `w [..., N, K]` to int8 storage at
    the given per-channel scales (`[..., N]`, absmax / qmax); a zero
    scale divides by 1."""
    qmax = (1 << (bits - 1)) - 1                      # 7 or 127
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(w / safe[..., None]), -qmax, qmax)
    return q.to(torch.int8)


def per_channel_quantize(w: torch.Tensor, algo: str):
    """Absmax quantization over the LAST axis of `w [..., N, K]`.
    `algo`: "weight_only_int8", "weight_only_int4" (values in [-7, 7],
    int8 storage, not packed) or "fp8" (e4m3, scale absmax / 448).
    Returns (q contiguous, scale [..., N] f32)."""
    w = w.float().contiguous()
    if algo == "fp8":
        scale = _channel_scales(w, _FP8_MAX)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        # the cast rounds to nearest even, as ml_dtypes does: a quotient
        # a hair above 448 rounds to 448 (only >= 464 would be NaN)
        q = (w / safe[..., None]).to(torch.float8_e4m3fn)
        return q, scale
    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise ValueError(f"unknown algo {algo!r}")
    bits = 4 if algo == "weight_only_int4" else 8
    scale = _channel_scales(w, (1 << (bits - 1)) - 1)
    return quantize_with_scales(w, scale, bits), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, [-8, 7]) two per byte along the
    last axis, `[..., K] -> [..., K/2]`, in the SPLIT-HALF layout: byte j
    holds `q[..., j]` in its low nibble and `q[..., K/2 + j]` in its
    high nibble."""
    k = q.shape[-1]
    if k % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got {k}")
    lo = q[..., :k // 2].to(torch.int32) & 0x0F
    hi = (q[..., k // 2:].to(torch.int32) & 0x0F) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """`[..., K/2]` split-half packed -> `[..., K]` int8, sign-extended
    (the exact inverse of `pack_int4`)."""
    b = q.to(torch.int32)
    lo = b & 0x0F
    hi = (b >> 4) & 0x0F
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def dequant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   weight_dtype: str = "int8") -> torch.Tensor:
    """`x [..., K] @ dequant(wq).T -> [..., N]` in x's dtype: `wq` is
    `[N, K]` int8 / fp8, or split-half packed int4 `[N, K/2]` with
    `weight_dtype="int4"`. Runs the weight-only gemm kernels (their
    plain versions on CPU tensors): each weight is converted to x's
    dtype, products accumulate in f32, and the scale is applied once at
    the end. (The JAX package's CPU path instead rounds `wq * scale` to
    x's dtype before its matmul; its Pallas kernel is what the port
    follows.)"""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if weight_dtype == "int4":
        out = qm.quant_matmul_int4(x2d, wq, scale, out_dtype=x.dtype)
    else:
        out = qm.quant_matmul(x2d, wq, scale, out_dtype=x.dtype)
    return out.reshape(lead + (wq.shape[0],))
