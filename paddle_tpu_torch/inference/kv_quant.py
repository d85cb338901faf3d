"""Quantized paged KV cache: int8 pools with per-slot f32 scale planes,
and the pool's byte accounting (the port of
`paddle_tpu/inference/kv_quant.py`).

K/V live in the pool as int8 beside an f32 scale plane shaped like the
pool minus its head_dim axis (`[NB, KVH, BS]` against `[NB, KVH, BS,
D]`): one scale per (block, kv head, slot), so each written token owns
its scale and a write never read-modify-writes a shared block scalar.
Symmetric absmax per (token, head): `scale = amax|x| / 127`,
`q = round(x / scale)` (half to even), clipped to +-127; a zero vector
stores q = 0 and scale = 0 and decodes to exact zeros.
"""
from __future__ import annotations

import torch

__all__ = ["QMAX", "quantize_kv", "dequantize_kv", "scale_shape",
           "kv_bytes_per_block", "kv_bytes_per_token"]

QMAX = 127.0   # int8 symmetric range


def quantize_kv(x: torch.Tensor):
    """`[..., D] -> (q int8 [..., D], scale f32 [...])` with one absmax
    scale per leading index (token, head)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, one ulp off the true division the CPU (and JAX) do
    scale = amax / amax.new_full((), QMAX)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """`q int8 [..., D] * scale f32 [...] -> f32 [..., D]`."""
    return q.float() * scale[..., None]


def scale_shape(cache_shape):
    """The scale plane of a pool: its shape minus the trailing head_dim
    axis (`[..., NB, KVH, BS, D] -> [..., NB, KVH, BS]`)."""
    return tuple(cache_shape[:-1])


def kv_bytes_per_block(kv_heads: int, block_size: int, head_dim: int,
                       kv_bits: int, dtype_bytes: int = 2,
                       num_layers: int = 1) -> int:
    """Device bytes ONE pool block costs across K+V and all layers.

    `kv_bits == 8`: int8 data plus one f32 scale per (head, slot);
    otherwise the native dtype (`dtype_bytes` per element)."""
    per_side = kv_heads * block_size * head_dim
    if kv_bits == 8:
        side = per_side * 1 + kv_heads * block_size * 4   # q + f32 scale
    else:
        side = per_side * dtype_bytes
    return 2 * side * num_layers                           # K and V


def kv_bytes_per_token(kv_heads: int, block_size: int, head_dim: int,
                       kv_bits: int, dtype_bytes: int = 2,
                       num_layers: int = 1) -> float:
    """Device bytes one cached token costs (block bytes / block_size)."""
    return kv_bytes_per_block(kv_heads, block_size, head_dim, kv_bits,
                              dtype_bytes, num_layers) / block_size
