"""Fused RMSNorm: a hand-written forward kernel and a plain backward.

The port of `paddle_tpu/ops/pallas/rms_norm.py`. `rms_norm(x, w, eps)`
normalises over the last axis of any leading shape. Its forward launches
the hand-written Hopper kernel (`csrc/rms_norm.cu`) on CUDA tensors and
runs the plain version, `rms_norm_ref`, on CPU tensors; there is no
fallback between the two, so a CUDA tensor the kernel does not take
raises. The kernel takes w in x's dtype only, as the model's norms are
(the JAX kernel also takes an f32 w with 16-bit x). Its backward is the
plain PyTorch transcription of the JAX package's `_rms_bwd_rule`, as the
JAX package leaves it to XLA.

The backward is plain PyTorch on the saved x and w, so under
`create_graph=True` it is recorded and differentiates again on either
device, as JAX differentiates its custom VJP's `jnp` rule.

Both roundings are the Pallas kernel's: `rsqrt` of the f32 mean square,
the normalised row rounded to x's dtype BEFORE the multiply by w (the
serving engine's `_rms` rounds after it, and the composite
`nn.functional.norm._rms_norm_fn` divides by `sqrt`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _support

__all__ = ["rms_norm", "rms_norm_ref", "rms_norm_bwd_ref", "supported",
           "rms_plan", "RmsPlan", "REGISTER_INSTANCES", "LAUNCHES"]

# launches of the CUDA kernel (one per forward on CUDA tensors)
LAUNCHES = _support.launch_counter("rms_norm")

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

# the kernel's register instances (csrc/rms_norm.cu `RMS_CASE`): (threads
# a row, 16-byte vectors a thread). Each takes the rows that fill more than
# half its vectors: 257 to 2048 vectors a row in all (H 2056 to 16384 in
# 16-bit types, 1028 to 8192 in f32), the widths the model's norms have.
REGISTER_INSTANCES = ((128, 4), (256, 4), (256, 8))


class RmsPlan(NamedTuple):
    tpr: int    # threads a row of the register instance; 0: the general one
    vpt: int    # 16-byte vectors a thread (register instance), else 0
    vec: int    # the general instance reads 16-byte vectors (1) or scalars


def rms_plan(h: int, itemsize: int, aligned: bool) -> RmsPlan:
    """The kernel instance for rows of `h` values of `itemsize` bytes;
    `aligned`: x's rows, w and y start on 16-byte boundaries. A row of
    whole 16-byte vectors takes the register instance whose vectors it
    fills more than half; every other row (narrower, wider, unaligned,
    or not whole vectors) takes the general instance."""
    per = 16 // itemsize
    whole = aligned and h % per == 0
    if whole:
        for tpr, vpt in REGISTER_INSTANCES:
            if tpr * vpt // 2 < h // per <= tpr * vpt:
                return RmsPlan(tpr, vpt, 1)
    return RmsPlan(0, 0, int(whole))


def supported(shape, dtype) -> bool:
    """`rms_norm.py:71-76`: rank >= 2, float32 / bfloat16 / float16."""
    return len(shape) >= 2 and dtype in _DTYPE_CODE


def rms_norm_ref(x2d, w, eps):
    """Plain version of the forward kernel (`_rms_fwd_kernel`):
    `(x * rsqrt(mean(x^2) + eps)).to(x.dtype) * w`, f32 math."""
    xf = x2d.float()
    inv = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    n = (xf * inv).to(x2d.dtype)
    return (n.float() * w.float()).to(x2d.dtype)


def rms_norm_bwd_ref(x2d, w, g, eps):
    """`_rms_bwd_rule` (`rms_norm.py:49-58`): f32 math, dx in x's dtype,
    dw in w's dtype."""
    xf = x2d.float()
    gf = g.float()
    inv = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    n = xf * inv
    gh = gf * w.float()
    dx = inv * (gh - n * (gh * n).mean(dim=-1, keepdim=True))
    dw = (gf * n).sum(dim=0)
    return dx.to(x2d.dtype), dw.to(w.dtype)


def _check(x2d, w):
    if x2d.device.type != "cuda" or w.device != x2d.device:
        raise ValueError(f"rms_norm: x and w must be on one CUDA device, "
                         f"got {x2d.device} and {w.device}")
    if x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"rms_norm: x must be bf16/f32/f16, got {x2d.dtype}")
    if w.dtype != x2d.dtype:
        raise ValueError(f"rms_norm: w must be in x's dtype, got "
                         f"{w.dtype} against {x2d.dtype}")
    if x2d.dim() != 2 or x2d.stride(1) != 1:
        raise ValueError(f"rms_norm: x must be [N, H] with a unit column "
                         f"stride, got {tuple(x2d.shape)} {x2d.stride()}")
    if w.shape != (x2d.shape[1],) or not w.is_contiguous():
        raise ValueError(f"rms_norm: w must be a contiguous [{x2d.shape[1]}],"
                         f" got {tuple(w.shape)}")


def _lib():
    fn = _support.load_library("rms_norm").rms_norm
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, ll, ll, ctypes.c_float, i, i, i, i,
                       p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x2d, w, eps):
    _check(x2d, w)
    rows, h = x2d.shape
    y = torch.empty((rows, h), dtype=x2d.dtype, device=x2d.device)
    if y.numel() == 0:              # nothing to write: no launch, no count
        return y
    item = x2d.element_size()
    # both instances read x, and the register one also w, as 16-byte
    # vectors; y is new, so aligned
    plan = rms_plan(h, item, x2d.data_ptr() % 16 == 0
                    and (x2d.stride(0) * item) % 16 == 0
                    and w.data_ptr() % 16 == 0)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = _lib()(x2d.data_ptr(), w.data_ptr(), y.data_ptr(), rows, h,
                    x2d.stride(0), y.stride(0), float(eps),
                    _DTYPE_CODE[x2d.dtype], *plan, stream)
    if rc != 0:
        raise RuntimeError(f"rms_norm launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return y


def rms_norm_fwd(x2d, w, eps):
    """The forward alone: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if x2d.device.type == "cpu":
        return rms_norm_ref(x2d, w, eps)
    return _launch(x2d, w, eps)


# The forward is the `torch.library` custom op `paddle_tpu_torch::rms_norm`,
# so a captured program (`jit.to_static`, `jit.save`) records it by name
# and launches the kernel wherever it runs on CUDA tensors; the launch
# counter moves only in its real implementation.

@torch.library.custom_op("paddle_tpu_torch::rms_norm", mutates_args=())
def _rms_op(x2d: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return rms_norm_fwd(x2d, w, eps)


@_rms_op.register_fake
def _(x2d, w, eps):
    return x2d.new_empty(x2d.shape)


def _rms_setup(ctx, inputs, output):
    x2d, w, eps = inputs
    ctx.save_for_backward(x2d, w)
    ctx.eps = eps


def _rms_backward(ctx, g):
    x2d, w = ctx.saved_tensors
    dx, dw = rms_norm_bwd_ref(x2d, w, g, ctx.eps)
    return dx, dw, None


_rms_op.register_autograd(_rms_backward, setup_context=_rms_setup)


def rms_norm(x, w, epsilon=1e-6):
    """Fused RMSNorm over the last axis of `x` (any leading shape), with
    gradients for x and w."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if x2d.stride(-1) != 1:
        x2d = x2d.contiguous()
    return _rms_op(x2d, w, float(epsilon)).reshape(shape)
