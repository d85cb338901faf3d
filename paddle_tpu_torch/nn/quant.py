"""Quantized execution: the port of `paddle_tpu/nn/quant/__init__.py`
(reference `python/paddle/nn/quant/quantized_linear.py`).

Per-output-channel absmax quantization to int8 / int4 / fp8-e4m3, the
split-half int4 packing, and `dequant_matmul`, which runs the weight-only
gemm kernels of `ops/kernels/quant_matmul.py` (rows 11-12; their plain
versions on CPU tensors). On top of them the paddle API on eager
Tensors: `weight_quantize` (a `[K, N]` paddle weight to `[N, K]`, or
packed `[N, K/2]`, and `[N]` f32 scales), `weight_dequantize`,
`weight_only_linear`, `llm_int8_linear`, `apply_per_channel_scale` and
the deploy Layer `WeightOnlyLinear` (weight and scale as buffers, so
`state_dict` carries them).

Layouts are the JAX package's: a quantized weight is `[N, K]` (the
transpose of the engine's `[K, N]` projection) with an `[N]` f32 scale;
int4 packs two values per byte into `[N, K/2]`.

`llm_int8_linear`'s main path multiplies int8 activations by int8
weights exactly in int32 (JAX's `dot_general` with an int32 result;
K = 4096 sums reach 4096 * 127^2, past float32's exact integers): on the
card `torch._int_mm` (M padded past 16, K and N to multiples of 8), on
the CPU an int32 matmul.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ..ops.kernels import quant_matmul as qm
from .layer.layers import Layer

__all__ = ["quantize_with_scales", "per_channel_quantize", "pack_int4",
           "unpack_int4", "dequant_matmul", "weight_quantize",
           "weight_dequantize", "weight_only_linear", "llm_int8_linear",
           "apply_per_channel_scale", "WeightOnlyLinear"]

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8", "fp8")

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


def _tensor(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def weight_quantize(x, algo: str = "weight_only_int8", arch=None,
                    group_size: int = -1, name=None):
    """Quantize a `[K, N]` float weight: (quantized `[N, K]`, or packed
    `[N, K/2]` for int4, and the `[N]` f32 scale), as Tensors that stop
    gradient. int4 needs an even K."""
    if algo not in _ALGOS:
        raise ValueError(f"algo must be one of {_ALGOS}, got {algo}")
    w = _tensor(x)._data.detach().float().t()                  # [N, K]
    if algo == "weight_only_int4" and w.shape[1] % 2:
        raise ValueError(
            f"weight_only_int4 packs two values per byte and needs an even "
            f"in_features, got {w.shape[1]}")
    q, scale = per_channel_quantize(
        w, "weight_only_int8" if algo == "llm.int8" else algo)
    if algo == "weight_only_int4":
        q = pack_int4(q)
    return Tensor._wrap(q), Tensor._wrap(scale)


def weight_dequantize(x, scale, algo: str = "weight_only_int8",
                      out_dtype="float16", group_size: int = -1, name=None):
    """The inverse of `weight_quantize`: the `[K, N]` float weight."""
    from ..framework import dtype as dtype_mod

    q, s = _tensor(x)._data, _tensor(scale)._data
    if algo == "weight_only_int4":
        q = unpack_int4(q)
    w = q.float() * s.float()[:, None]
    return Tensor._wrap(w.t().to(dtype_mod.convert_dtype(out_dtype)
                                 .torch_dtype))


def _woq_impl(x, wq, scale, bias, *, weight_dtype, has_bias):
    # under AMP O2 the scale arrives in the AMP dtype, as in the JAX
    # package (whose kernel reads it as f32): the kernels take it as f32
    out = dequant_matmul(x, wq, scale.float().contiguous(), weight_dtype)
    if has_bias:
        out = out + bias
    return out


dispatch.register_op("weight_only_linear", _woq_impl)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype: str = "int8", arch=None,
                       group_size: int = -1, name=None):
    """`x @ dequant(weight).T + bias` with int8 / int4 / fp8 weights,
    through the weight-only gemm kernels; differentiable in x (int8 /
    fp8) as JAX's `quant_matmul` is."""
    if weight_scale is None:
        raise ValueError("weight_scale is required (per-channel f32 scale)")
    x, weight, ws = _tensor(x), _tensor(weight), _tensor(weight_scale)
    has_bias = bias is not None
    b = _tensor(bias) if has_bias else Tensor._wrap(
        torch.zeros((1,), dtype=torch.float32, device=x._data.device))
    return dispatch.apply("weight_only_linear", [x, weight, ws, b],
                          {"weight_dtype": str(weight_dtype),
                           "has_bias": has_bias})


def _int8_product(xq, wq):
    """`xq [M, K] int8 @ wq [N, K].T` exactly, as int32."""
    if xq.device.type != "cuda":
        return torch.matmul(xq.to(torch.int32), wq.to(torch.int32).t())
    m, k = xq.shape
    n = wq.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.zeros((mp, kp), dtype=torch.int8, device=xq.device)
    a[:m, :k] = xq
    b = torch.zeros((np_, kp), dtype=torch.int8, device=xq.device)
    b[:n, :k] = wq
    return torch._int_mm(a, b.t())[:m, :n]


def _llm_int8_impl(x, wq, scale, *, threshold):
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    # outlier feature columns by max |activation| (LLM.int8 decomposition)
    outlier = x2d.abs().amax(dim=0) >= threshold                   # [K]
    zero = torch.zeros((), dtype=x2d.dtype, device=x2d.device)
    x_main = torch.where(outlier[None, :], zero, x2d)
    x_out = torch.where(outlier[None, :], x2d, zero)
    # per-row int8 activations times int8 weights, summed in int32,
    # rescaled by (row scale * column scale)
    row_s = x_main.abs().amax(dim=1, keepdim=True) / \
        torch.full((), 127.0, dtype=x2d.dtype, device=x2d.device)
    safe = torch.where(row_s > 0, row_s, torch.ones_like(row_s))
    xq = torch.clamp(torch.round(x_main / safe), -127, 127).to(torch.int8)
    main = _int8_product(xq, wq).float()
    main = main * safe * scale[None, :]
    # outliers in full precision against the dequantized columns
    wf = wq.to(x.dtype) * scale[:, None].to(x.dtype)               # [N, K]
    out = main.to(x.dtype) + torch.matmul(x_out, wf.t())
    return out.reshape(lead + (wq.shape[0],))


dispatch.register_op("llm_int8_linear", _llm_int8_impl)


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold: float = 6.0, name=None):
    """LLM.int8(): activation columns with |x| >= `threshold` run in x's
    dtype against the dequantized weight; the rest through int8
    activations and the int8 weight, summed exactly in int32."""
    out = dispatch.apply("llm_int8_linear",
                         [_tensor(x), _tensor(weight),
                          _tensor(weight_scale)],
                         {"threshold": float(threshold)})
    if bias is not None:
        out = out + _tensor(bias)
    return out


def apply_per_channel_scale(x, scales, name=None):
    """`x * scales` over the last axis (smooth-quant's prescale)."""
    return _tensor(x) * _tensor(scales)


class WeightOnlyLinear(Layer):
    """The deploy form of a Linear: an int8 / int4 / fp8 weight and its
    scale as buffers (so `state_dict` and checkpoints carry them), run
    by `weight_only_linear` (the convert target of PTQ)."""

    def __init__(self, weight, weight_scale, bias=None, weight_dtype="int8"):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("weight_scale", weight_scale)
        self.bias = bias
        self.weight_dtype = weight_dtype

    def forward(self, x):
        return weight_only_linear(x, self.weight, bias=self.bias,
                                  weight_scale=self.weight_scale,
                                  weight_dtype=self.weight_dtype)

    @staticmethod
    def from_linear(linear, algo: str = "weight_only_int8"):
        wq, scale = weight_quantize(linear.weight, algo=algo)
        dt = {"weight_only_int8": "int8", "weight_only_int4": "int4",
              "fp8": "fp8"}.get(algo, "int8")
        return WeightOnlyLinear(wq, scale, bias=linear.bias,
                                weight_dtype=dt)
