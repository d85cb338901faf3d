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
"""
from __future__ import annotations

import ctypes

import torch

from . import _support

__all__ = ["quant_matmul", "quant_matmul_ref", "quant_matmul_int4",
           "quant_matmul_int4_ref", "LAUNCHES", "LAUNCHES_INT4"]

# launches of the CUDA kernels (one per call on CUDA tensors)
LAUNCHES = _support.launch_counter("quant_matmul")
LAUNCHES_INT4 = _support.launch_counter("quant_matmul_int4")

_W_FMT = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


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


def quant_matmul(x2d, wq, scale, out_dtype=None):
    """`x2d [M, K] @ dequant(wq [N, K], scale [N]).T -> [M, N]`, wq int8,
    float8_e4m3fn or float8_e5m2. CPU tensors take the plain version;
    CUDA tensors launch the kernel (K a multiple of 16) or raise."""
    if x2d.device.type == "cpu":
        return quant_matmul_ref(x2d, wq, scale, out_dtype)
    return _launch(x2d, wq, scale, out_dtype, int4=False)


def quant_matmul_int4(x2d, wq_packed, scale, out_dtype=None):
    """`x2d [M, K] @ dequant(wq_packed [N, K/2], scale [N]).T -> [M, N]`
    with split-half packed int4 weights (`nn.quant.pack_int4`). CPU
    tensors take the plain version; CUDA tensors launch the kernel (K a
    multiple of 32) or raise."""
    if x2d.device.type == "cpu":
        return quant_matmul_int4_ref(x2d, wq_packed, scale, out_dtype)
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
        if wq.dtype != torch.int8 or 2 * kw != k or k % 32:
            raise ValueError(f"{name}: wq must be int8 [N, K/2] packed with "
                             f"K % 32 == 0, got {tuple(wq.shape)} "
                             f"{wq.dtype} against K = {k}")
    elif wq.dtype not in _W_FMT or kw != k or k % 16:
        raise ValueError(f"{name}: wq must be int8/float8 [N, K] with "
                         f"K % 16 == 0, got {tuple(wq.shape)} {wq.dtype} "
                         f"against K = {k}")
    if scale.dtype != torch.float32 or scale.shape != (n,) \
            or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be a contiguous f32 [{n}], "
                         f"got {tuple(scale.shape)} {scale.dtype}")
    # 16-byte rows: the kernel stages x and wq with 16-byte copies
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
            ([i, i] if int4 else [i, i, i]) + [p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x2d, wq, scale, out_dtype, int4):
    out_dtype = out_dtype or x2d.dtype
    _check(x2d, wq, scale, out_dtype, int4)
    m, k = x2d.shape
    n = wq.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x2d.device)
    fn = _lib(int4)
    codes = (_DTYPE_CODE[x2d.dtype], _DTYPE_CODE[out_dtype]) if int4 else \
        (_DTYPE_CODE[x2d.dtype], _W_FMT[wq.dtype], _DTYPE_CODE[out_dtype])
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                out.data_ptr(), m, n, k, x2d.stride(0), wq.stride(0),
                out.stride(0), *codes, stream)
    if rc != 0:
        raise RuntimeError(f"{'quant_matmul_int4' if int4 else 'quant_matmul'}"
                           f" launch failed: CUDA error {rc}")
    (LAUNCHES_INT4 if int4 else LAUNCHES).count += 1
    return out
