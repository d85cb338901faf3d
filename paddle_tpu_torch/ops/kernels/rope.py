"""Fused rotary position embedding: a hand-written kernel forward and
backward.

The port of `paddle_tpu/ops/pallas/rope.py`. `fused_rope(q, k, cos, sin,
offset)` rotates q and k `[B, S, H, D]` together, split-half ("rotate
half": pairs `(x[i], x[i + D/2])`), with the `[T, D/2]` tables sliced at
`offset`. On CUDA tensors both directions launch the hand-written Hopper
kernel (`csrc/rope.cu`); the backward is the same kernel with the sine
negated (`conj`), as `_rope_bwd_rule` runs it, and cos/sin get no
gradient. On CPU tensors the plain version, `rope_ref`, runs instead;
there is no fallback between the two, so a CUDA tensor the kernel does
not take raises.

The math is f32 and rounds once to the output dtype. The tables come in
f32 or in q's dtype; a table in another float dtype is cast to f32 first
(the JAX kernel's `.astype(float32)`). The kernel reads q and k through
their strides (a unit D stride is all it needs), so views of one qkv
product are rotated in place of a copy; the outputs are contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from . import _support

__all__ = ["fused_rope", "rope_ref", "supported", "LAUNCHES"]

# launches of the CUDA kernel (one per forward and one per backward on
# CUDA tensors)
LAUNCHES = _support.launch_counter("fused_rope")

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def supported(q_shape, dtype) -> bool:
    """`rope.py:83-88`: rank 4, an even head dim, f32 / bf16 / f16."""
    return len(q_shape) == 4 and q_shape[-1] % 2 == 0 \
        and dtype in _DTYPE_CODE


def rope_ref(q, k, cos, sin, conj=False):
    """Plain version of the kernel (`_rope_kernel`): q, k `[B, S, H, D]`,
    cos/sin `[S, D/2]` (already sliced); with `conj` the sine is negated
    (the backward). f32 math, one rounding to each input's dtype."""
    c = cos[None, :, None, :].float()
    s = sin[None, :, None, :].float()
    if conj:
        s = -s

    def rot(x):
        xf = x.float()
        d2 = x.shape[-1] // 2
        x1, x2 = xf[..., :d2], xf[..., d2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _check(q, k, cos, sin):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"fused_rope: unsupported device {dev}")
    if not supported(tuple(q.shape), q.dtype):
        raise ValueError(f"fused_rope: q must be [B, S, H, D] with an even "
                         f"D in bf16/f32/f16, got {tuple(q.shape)} "
                         f"{q.dtype}")
    if k.shape != q.shape or k.dtype != q.dtype:
        raise ValueError(f"fused_rope: k must match q, got "
                         f"{tuple(k.shape)} {k.dtype} against "
                         f"{tuple(q.shape)} {q.dtype}")
    b, s, _h, d = q.shape
    if b > 65535:
        raise ValueError(f"fused_rope: batch {b} > 65535")
    for name, t in (("k", k), ("cos", cos), ("sin", sin)):
        if t.device != dev:
            raise ValueError(f"fused_rope: {name} is on {t.device}, q on "
                             f"{dev}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (s, d // 2):
            raise ValueError(f"fused_rope: {name} must be [{s}, {d // 2}],"
                             f" got {tuple(t.shape)}")


def _lib():
    fn = _support.load_library("rope").fused_rope
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 9
        fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    """16-byte aligned at every index of the leading dims."""
    item = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * item) % 16 == 0 for st in t.stride()[:-1])


def _launch(q, k, cos, sin, conj):
    _check(q, k, cos, sin)
    if q.stride(-1) != 1:
        q = q.contiguous()
    if k.stride(-1) != 1:
        k = k.contiguous()
    if cos.dtype not in (torch.float32, q.dtype):
        cos = cos.float()
    if sin.dtype != cos.dtype:
        sin = sin.to(cos.dtype)
    if cos.stride(-1) != 1 or sin.stride() != cos.stride():
        cos, sin = cos.contiguous(), sin.contiguous()
    oq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ok = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    if oq.numel() == 0:             # nothing to write: no launch, no count
        return oq, ok
    b, s, h, d = q.shape
    per = 16 // q.element_size()    # elements per 16-byte vector
    vec = int((d // 2) % per == 0 and _aligned(q) and _aligned(k)
              and _aligned(cos) and _aligned(sin))
    dims = (ctypes.c_int * 8)(b, s, h, d, _DTYPE_CODE[q.dtype],
                              int(cos.dtype == torch.float32), int(conj),
                              vec)
    strides = (ctypes.c_longlong * 7)(*q.stride()[:3], *k.stride()[:3],
                                      cos.stride(0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()(q.data_ptr(), k.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), oq.data_ptr(), ok.data_ptr(), dims,
                    strides, stream)
    if rc != 0:
        raise RuntimeError(f"fused_rope launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return oq, ok


def _rope(q, k, cos, sin, conj):
    """One direction: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return rope_ref(q, k, cos, sin, conj)
    return _launch(q, k, cos, sin, conj)


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope(q, k, cos, sin, False)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        dq, dk = _rope(gq, gk, cos, sin, True)
        return dq, dk, None, None


def fused_rope(q, k, cos, sin, offset=0):
    """q, k `[B, S, H, D]` rotated by the rows `offset .. offset + S - 1`
    of cos/sin `[T, D/2]`; differentiable in q and k. `offset + S > T`
    raises."""
    s = q.shape[1]
    if offset < 0 or offset + s > cos.shape[0] or sin.shape != cos.shape:
        raise ValueError(f"fused_rope: rows {offset}..{offset + s - 1} of "
                         f"tables {tuple(cos.shape)} / {tuple(sin.shape)}")
    return _Rope.apply(q, k, cos[offset:offset + s], sin[offset:offset + s])
