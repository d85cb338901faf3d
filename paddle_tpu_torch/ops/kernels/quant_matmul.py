"""Weight-only quantized gemms: `quant_matmul` (int8 / fp8 weights) and
`quant_matmul_int4` (split-half packed int4 weights).

The port of `paddle_tpu/ops/pallas/quant_matmul.py`: on CUDA tensors each
wrapper launches its hand-written Hopper kernel (`csrc/quant_matmul.cu`),
on CPU tensors it runs its plain PyTorch version (`quant_matmul_ref`,
`quant_matmul_int4_ref`). There is no fallback between the two: a CUDA
tensor the kernel does not take raises.

Both compute `out = (x @ cvt(w).T) * scale` with the Pallas kernels'
arithmetic: every weight converted to x's dtype, products accumulated in
f32, the `[N]` scale applied once after the accumulation, the result
cast to `out_dtype` (x's dtype by default).

With bf16 x every weight format runs one kernel design, which splits K
over the CTAs of a thread-block cluster; `gemm_plan` chooses the split on
the host from the shape, the format's weight tile and the card's SM
count alone (never from `out_dtype`), and the cluster sums its partial
tiles in a fixed order, so a call gives the same bits every time.

`quant_matmul` is differentiable in x as JAX's `custom_vjp` is
(`quant_matmul.py:49-72`): the cotangent of x is
`g @ (wq.to(g.dtype) * scale[:, None].to(g.dtype))`, a plain matmul on
both devices (XLA computes it in the JAX package, outside Pallas), and
the weights and scale get none. `quant_matmul_int4` is forward-only in
the JAX package (a deploy format): on a CUDA tensor that requires grad
its backward raises `KernelNotDifferentiableError`; on CPU tensors its
plain version differentiates through ordinary torch ops, as JAX's CPU
path does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _support

__all__ = ["quant_matmul", "quant_matmul_ref", "quant_matmul_int4",
           "quant_matmul_int4_ref", "gemm_plan", "GemmPlan", "LAUNCHES",
           "LAUNCHES_INT4"]

# launches of the CUDA kernels (one per call on CUDA tensors)
LAUNCHES = _support.launch_counter("quant_matmul")
LAUNCHES_INT4 = _support.launch_counter("quant_matmul_int4")

_W_FMT = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# `qmm_wgmma_kernel`'s tiling (csrc/quant_matmul.cu): a CTA owns 128
# weight rows (output columns) and up to 64 tokens, and streams weight
# tiles of 128 bytes of K (128 k values of an 8-bit weight through 4
# stages; 256 of a packed int4 one, with twice x's columns, through 3);
# the CTAs of one column tile form a cluster of at most 8 (the portable
# cluster size). Up to 40 tokens two CTAs share an SM.
PLAN_ROWS = 128
PLAN_K_TILE = 128
PLAN_K_TILE_INT4 = 256
PLAN_MAX_TOKENS = 64
PLAN_STAGES = 4
PLAN_STAGES_INT4 = 3
PLAN_MAX_SPLITS = 8
# a launch of at most 7/4 CTAs an SM: one wave at two CTAs an SM, short of
# the 256 CTAs at which 8 splits of 32 column tiles measured slower than 7
# (int8 and int4 alike: `kernel_compare --sweep-splits`)
PLAN_MAX_CTAS_PER_SM = (7, 4)
SMEM_PER_BLOCK = 232448           # an H100's opt-in shared memory a CTA
SMEM_PER_SM = 233472              # ... and an SM's, 1 KB a CTA reserved


class GemmPlan(NamedTuple):
    tokens: int          # tokens a CTA (wgmma's N): M rounded up to 8
    m_tiles: int
    n_tiles: int
    k_tiles: int         # weight tiles (PLAN_K_TILE / PLAN_K_TILE_INT4
                         # k values) along K
    splits: int          # CTAs of a cluster, each one slice of K
    k_tiles_per_split: int
    ctas: int
    smem_bytes: int      # dynamic shared memory a CTA
    partial_bytes: int   # the f32 partial tile, over the drained stages


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def gemm_plan(m: int, n: int, k: int, sms: int,
              int4: bool = False) -> GemmPlan:
    """The K split of the bf16 kernel for `x [m, k] @ w[n, k].T` on a
    card of `sms` SMs, for 8-bit weights or (`int4`) packed int4 ones.
    Tiles that cover more than half the SMs are not split: a split only
    adds the cluster's reduction. Fewer tiles take the most splits (at
    most 8, at most one per weight tile) that keep the launch within
    `PLAN_MAX_CTAS_PER_SM` CTAs an SM. Every split is a whole
    number of weight tiles (the last one ragged only where K is) and none
    is empty. A pure function of the shape, the format and the SM
    count."""
    k_tile = PLAN_K_TILE_INT4 if int4 else PLAN_K_TILE
    stages = PLAN_STAGES_INT4 if int4 else PLAN_STAGES
    x_boxes = 4 if int4 else 2        # x's 64-column boxes a stage
    tokens = min(PLAN_MAX_TOKENS, _cdiv(max(m, 1), 8) * 8)
    m_tiles, n_tiles = _cdiv(m, tokens), _cdiv(n, PLAN_ROWS)
    k_tiles = max(1, _cdiv(k, k_tile))
    tiles = max(m_tiles * n_tiles, 1)
    num, den = PLAN_MAX_CTAS_PER_SM
    splits = 1
    if 2 * tiles <= sms:
        splits = max(1, min(PLAN_MAX_SPLITS, k_tiles,
                            num * sms // (den * tiles)))
    per = _cdiv(k_tiles, splits)
    splits = _cdiv(k_tiles, per)
    stage = PLAN_ROWS * 128 + x_boxes * tokens * 128
    return GemmPlan(tokens, m_tiles, n_tiles, k_tiles, splits, per,
                    m_tiles * n_tiles * splits,
                    stages * stage + 2 * stages * 8 + 1024,
                    tokens * (PLAN_ROWS + 4) * 4)


def quant_matmul_ref(x2d, wq, scale, out_dtype=None):
    """Plain version of `quant_matmul`: `x2d [M, K]` (bf16/f32) against
    `wq [N, K]` int8 / float8_e4m3fn / float8_e5m2 and `scale [N]` f32
    -> `[M, N]`."""
    out_dtype = out_dtype or x2d.dtype
    w = wq.to(x2d.dtype).float()              # exact: x's dtype holds it
    acc = torch.matmul(x2d.float(), w.t())
    return (acc * scale.float()[None, :]).to(out_dtype)


def quant_matmul_int4_ref(x2d, wq_packed, scale, out_dtype=None):
    """Plain version of `quant_matmul_int4`: `wq_packed [N, K/2]` int8
    in the split-half layout."""
    from ...nn.quant import unpack_int4   # nn.quant imports this module

    return quant_matmul_ref(x2d, unpack_int4(wq_packed), scale, out_dtype)


def _forward(x2d, wq, scale, out_dtype):
    if x2d.device.type == "cpu":
        return quant_matmul_ref(x2d, wq, scale, out_dtype)
    return _launch(x2d, wq, scale, out_dtype, int4=False)


class _QuantMatmul(torch.autograd.Function):
    """The int8 / fp8 gemm with JAX's VJP: x's cotangent is `g` times the
    weight dequantized in g's dtype; wq and scale get none."""

    @staticmethod
    def forward(ctx, x2d, wq, scale, out_dtype):
        ctx.save_for_backward(wq, scale)
        return _forward(x2d, wq, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        wq, scale = ctx.saved_tensors
        wf = wq.to(g.dtype) * scale[:, None].to(g.dtype)       # [N, K]
        return torch.matmul(g, wf), None, None, None


class _Int4NoGrad(torch.autograd.Function):
    """The int4 kernel's output on the tape, with a backward that
    refuses: JAX's int4 gemm has no VJP."""

    @staticmethod
    def forward(ctx, x2d, wq_packed, scale, out_dtype):
        return _launch(x2d, wq_packed, scale, out_dtype, int4=True)

    @staticmethod
    def backward(ctx, g):
        raise _support.KernelNotDifferentiableError(
            "quant_matmul_int4 (a deploy format: JAX's int4 gemm has no "
            "VJP)")


def _wants_grad(x2d):
    return torch.is_grad_enabled() and x2d.requires_grad


def quant_matmul(x2d, wq, scale, out_dtype=None):
    """`x2d [M, K] @ dequant(wq [N, K], scale [N]).T -> [M, N]`, wq int8,
    float8_e4m3fn or float8_e5m2. CPU tensors take the plain version;
    CUDA tensors launch the kernel (K a multiple of 16) or raise.
    Differentiable in x by JAX's rule."""
    if _wants_grad(x2d):
        return _QuantMatmul.apply(x2d, wq, scale, out_dtype)
    return _forward(x2d, wq, scale, out_dtype)


def quant_matmul_int4(x2d, wq_packed, scale, out_dtype=None):
    """`x2d [M, K] @ dequant(wq_packed [N, K/2], scale [N]).T -> [M, N]`
    with split-half packed int4 weights (`nn.quant.pack_int4`). CPU
    tensors take the plain version; CUDA tensors launch the kernel (K a
    positive multiple of 32) or raise, and a backward through it
    raises `KernelNotDifferentiableError`."""
    if x2d.device.type == "cpu":
        return quant_matmul_int4_ref(x2d, wq_packed, scale, out_dtype)
    if _wants_grad(x2d):
        return _Int4NoGrad.apply(x2d, wq_packed, scale, out_dtype)
    return _launch(x2d, wq_packed, scale, out_dtype, int4=True)


def _check(x2d, wq, scale, out_dtype, int4):
    name = "quant_matmul_int4" if int4 else "quant_matmul"
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2d.device}")
    for n, t in (("wq", wq), ("scale", scale)):
        if t.device != x2d.device:
            raise ValueError(f"{name}: {n} is on {t.device}, x on "
                             f"{x2d.device}")
    if x2d.dim() != 2 or x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be [M, K] bf16/f32, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: out_dtype must be bf16/f32, got "
                         f"{out_dtype}")
    m, k = x2d.shape
    if wq.dim() != 2:
        raise ValueError(f"{name}: wq must be 2-D, got {tuple(wq.shape)}")
    n, kw = wq.shape
    if int4:
        if wq.dtype != torch.int8 or 2 * kw != k or k % 32 or k == 0:
            raise ValueError(f"{name}: wq must be int8 [N, K/2] packed with "
                             f"K % 32 == 0 and K > 0, got {tuple(wq.shape)} "
                             f"{wq.dtype} against K = {k}")
    elif wq.dtype not in _W_FMT or kw != k or k % 16 or k == 0:
        raise ValueError(f"{name}: wq must be int8/float8 [N, K] with "
                         f"K % 16 == 0 and K > 0, got {tuple(wq.shape)} "
                         f"{wq.dtype} against K = {k}")
    if scale.dtype != torch.float32 or scale.shape != (n,) \
            or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be a contiguous f32 [{n}], "
                         f"got {tuple(scale.shape)} {scale.dtype}")
    # 16-byte rows: the kernels read x and wq by TMA or 16-byte copies
    if x2d.stride(1) != 1 or (x2d.stride(0) * x2d.element_size()) % 16 \
            or x2d.data_ptr() % 16:
        raise ValueError(f"{name}: x rows must be 16-byte aligned with a "
                         f"unit column stride, got strides {x2d.stride()}")
    if wq.stride(1) != 1 or wq.stride(0) % 16 or wq.data_ptr() % 16:
        raise ValueError(f"{name}: wq rows must be 16-byte aligned with a "
                         f"unit column stride, got strides {wq.stride()}")


def _lib(int4):
    lib = _support.load_library("quant_matmul")
    fn = lib.quant_matmul_int4 if int4 else lib.quant_matmul
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 3 + [ll] * 3 + \
            ([i, i, i] if int4 else [i, i, i, i]) + [p]
        fn.restype = ctypes.c_int
    return fn


def _kernel_args(x2d, wq, scale, out, int4, sms):
    """The C entry point's arguments but the stream: pointers, shape,
    strides, dtype codes (and the 8-bit format) and, last, the split of
    `gemm_plan` for the weight's format."""
    m, k = x2d.shape
    n = wq.shape[0]
    if int4:
        codes = (_DTYPE_CODE[x2d.dtype], _DTYPE_CODE[out.dtype])
    else:
        codes = (_DTYPE_CODE[x2d.dtype], _W_FMT[wq.dtype],
                 _DTYPE_CODE[out.dtype])
    return (x2d.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k, x2d.stride(0), wq.stride(0), out.stride(0), *codes,
            gemm_plan(m, n, k, sms, int4).splits)


def _launch(x2d, wq, scale, out_dtype, int4):
    out_dtype = out_dtype or x2d.dtype
    _check(x2d, wq, scale, out_dtype, int4)
    out = torch.empty((x2d.shape[0], wq.shape[0]), dtype=out_dtype,
                      device=x2d.device)
    fn = _lib(int4)
    with torch.cuda.device(x2d.device):
        args = _kernel_args(x2d, wq, scale, out, int4,
                            _support.sm_count(torch.cuda.current_device()))
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{'quant_matmul_int4' if int4 else 'quant_matmul'}"
                           f" launch failed: CUDA error {rc}")
    (LAUNCHES_INT4 if int4 else LAUNCHES).add()
    return out
