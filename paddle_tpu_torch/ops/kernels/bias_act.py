"""Fused bias + activation and SwiGLU: hand-written kernel forwards and
plain backwards.

The port of `paddle_tpu/ops/pallas/bias_act.py`. Two functions launch
the hand-written Hopper kernel (`csrc/bias_act.cu`) on CUDA tensors and
run their plain PyTorch versions on CPU tensors; there is no fallback
between the two, so a CUDA tensor the kernel does not take raises:
- `fused_bias_act(x, bias, act_method)`: `act(x + bias)` over the last
  axis, or with "swiglu" / "geglu" `act(a) * g` over its two halves
  (`[..., H] -> [..., H/2]`); plain version `bias_act_ref`. `bias=None`
  is zeros in x's dtype, as `bias_act.py:107-108` makes it.
- `swiglu(x, y)`: `silu(x) * y`; plain version `swiglu_ref`. With
  `y=None`, x is split in halves through `fused_bias_act(x, None,
  "swiglu")`, as the JAX package does.

The math is f32 and rounds once to x's dtype; gelu computes erf by the
Abramowitz-Stegun polynomial 7.1.26 (`_erf_approx`), in the plain
versions too, so kernel and plain version compute one function. The
backwards are plain PyTorch, as the JAX package leaves them to XLA:
`fused_bias_act`'s is autograd through `bias_act_ref` (`_ba_bwd` takes
the vjp of the reference; relu's `maximum(x, 0)` gives half the
cotangent where `x + bias` is exactly 0, as JAX's does), and `swiglu`'s
is `_sw2_bwd`'s f32 formula.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _support

__all__ = ["fused_bias_act", "swiglu", "bias_act_ref", "swiglu_ref",
           "swiglu_bwd_ref", "supported", "ACT_CODES", "LAUNCHES",
           "LAUNCHES_SWIGLU"]

# launches of the CUDA kernel through each entry point (one per forward
# on CUDA tensors)
LAUNCHES = _support.launch_counter("bias_act")
LAUNCHES_SWIGLU = _support.launch_counter("swiglu")

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}

# act_method -> (kernel activation code, GLU over the two halves)
ACT_CODES = {"identity": (0, 0), "gelu": (1, 0), "gelu_tanh": (2, 0),
             "relu": (3, 0), "silu": (4, 0), "swish": (4, 0),
             "sigmoid": (5, 0), "swiglu": (4, 1), "geglu": (1, 1)}

_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def supported(dtype) -> bool:
    """The dtypes the kernel takes: the JAX package's `_pallas_on`, which
    routes `swiglu` and `fused_bias_act` to the Pallas kernels."""
    return dtype in _DTYPE_CODE


def _erf_approx(x):
    """`_erf_approx`: Abramowitz-Stegun 7.1.26, in the same order."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_erf(x):
    return x * 0.5 * (1.0 + _erf_approx(x * 0.7071067811865476))


def _gelu_tanh(x):
    """`jax.nn.gelu(x, approximate=True)`, in the same order."""
    return x * (0.5 * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))))


def _silu(x):
    return x * torch.sigmoid(x)


_ACTS = {
    "gelu": _gelu_erf,
    "gelu_tanh": _gelu_tanh,
    # torch.maximum's gradient at a tie is half the cotangent to each
    # side, as jnp.maximum's (torch.relu's is 0)
    "relu": lambda x: torch.maximum(x, torch.zeros_like(x)),
    "silu": _silu,
    "swish": _silu,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def _check_act(act_method, h):
    if act_method not in ACT_CODES:
        raise KeyError(f"fused_bias_act: unknown act_method "
                       f"{act_method!r}; expected one of {sorted(ACT_CODES)}")
    if ACT_CODES[act_method][1] and h % 2:
        raise ValueError(f"fused_bias_act: {act_method} splits the last "
                         f"axis in halves, got an odd width {h}")


def bias_act_ref(x2d, bias, act_method):
    """Plain version of `_kernel` (`_ref_bias_act`): f32 math, one rounding
    to x's dtype."""
    _check_act(act_method, x2d.shape[-1])
    xf = x2d.float() + bias.float()
    if act_method in ("swiglu", "geglu"):
        a, b = torch.chunk(xf, 2, dim=-1)
        inner = _ACTS["silu" if act_method == "swiglu" else "gelu"](a)
        return (inner * b).to(x2d.dtype)
    return _ACTS[act_method](xf).to(x2d.dtype)


def swiglu_ref(x2d, y2d):
    """Plain version of `_kernel2`: `silu(x) * y` in f32, one rounding."""
    return (_silu(x2d.float()) * y2d.float()).to(x2d.dtype)


def swiglu_bwd_ref(x2d, y2d, g):
    """`_sw2_bwd` (`bias_act.py:144-154`): the f32 formula, dx and dy in
    their inputs' dtypes."""
    xf, yf, gf = x2d.float(), y2d.float(), g.float()
    sig = torch.sigmoid(xf)
    silu = xf * sig
    dx = gf * yf * (sig * (1 + xf * (1 - sig)))
    dy = gf * silu
    return dx.to(x2d.dtype), dy.to(y2d.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _fn(name):
    fn = getattr(_support.load_library("bias_act"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p, p, p, i, i, ll, i, i, i, i, i, p]
                       if name == "bias_act" else
                       [p, p, p, i, i, ll, ll, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _check_x(name, x2d, *others):
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2d.device}")
    if x2d.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be bf16/f32/f16, got {x2d.dtype}")
    for oname, t in others:
        if t.device != x2d.device:
            raise ValueError(f"{name}: {oname} is on {t.device}, x on "
                             f"{x2d.device}")
    if x2d.dim() != 2 or x2d.stride(1) != 1:
        raise ValueError(f"{name}: x must be [R, H] with a unit column "
                         f"stride, got {tuple(x2d.shape)} {x2d.stride()}")


def _row_aligned(t):
    return t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) \
        % 16 == 0


def _launch_bias_act(x2d, bias, act_method):
    _check_x("bias_act", x2d, ("bias", bias))
    rows, h = x2d.shape
    if bias.dtype not in (x2d.dtype, torch.float32) or bias.shape != (h,) \
            or not bias.is_contiguous():
        raise ValueError(f"bias_act: bias must be a contiguous [{h}] in "
                         f"{x2d.dtype} or float32, got {tuple(bias.shape)} "
                         f"{bias.dtype}")
    code, glu = ACT_CODES[act_method]
    hout = h // 2 if glu else h
    y = torch.empty((rows, hout), dtype=x2d.dtype, device=x2d.device)
    if y.numel() == 0:              # nothing to write: no launch, no count
        return y
    per = 16 // x2d.element_size()
    vec = int(hout % per == 0 and _row_aligned(x2d)
              and bias.data_ptr() % 16 == 0)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = _fn("bias_act")(x2d.data_ptr(), bias.data_ptr(), y.data_ptr(),
                             rows, h, x2d.stride(0), code, glu,
                             _DTYPE_CODE[x2d.dtype],
                             int(bias.dtype == torch.float32), vec, stream)
    if rc != 0:
        raise RuntimeError(f"bias_act launch failed: CUDA error {rc}")
    LAUNCHES.add()
    return y


def _launch_swiglu(x2d, y2d):
    _check_x("swiglu", x2d, ("y", y2d))
    if y2d.shape != x2d.shape or y2d.dtype != x2d.dtype \
            or y2d.stride(1) != 1:
        raise ValueError(f"swiglu: y must match x with a unit column "
                         f"stride, got {tuple(y2d.shape)} {y2d.dtype} "
                         f"{y2d.stride()} against {tuple(x2d.shape)} "
                         f"{x2d.dtype}")
    rows, h = x2d.shape
    out = torch.empty((rows, h), dtype=x2d.dtype, device=x2d.device)
    if out.numel() == 0:
        return out
    per = 16 // x2d.element_size()
    vec = int(h % per == 0 and _row_aligned(x2d) and _row_aligned(y2d))
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = _fn("swiglu")(x2d.data_ptr(), y2d.data_ptr(), out.data_ptr(),
                           rows, h, x2d.stride(0), y2d.stride(0),
                           _DTYPE_CODE[x2d.dtype], vec, stream)
    if rc != 0:
        raise RuntimeError(f"swiglu launch failed: CUDA error {rc}")
    LAUNCHES_SWIGLU.add()
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, bias, act_method):
        ctx.save_for_backward(x2d, bias)
        ctx.act_method = act_method
        if x2d.device.type == "cpu":
            return bias_act_ref(x2d, bias, act_method)
        return _launch_bias_act(x2d, bias, act_method)

    @staticmethod
    def backward(ctx, g):
        x2d, bias = ctx.saved_tensors
        with torch.enable_grad():
            xr = x2d.detach().requires_grad_()
            br = bias.detach().requires_grad_()
            y = bias_act_ref(xr, br, ctx.act_method)
            dx, db = torch.autograd.grad(y, (xr, br), g)
        return dx, db, None


class _Swiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, y2d):
        ctx.save_for_backward(x2d, y2d)
        if x2d.device.type == "cpu":
            return swiglu_ref(x2d, y2d)
        return _launch_swiglu(x2d, y2d)

    @staticmethod
    def backward(ctx, g):
        x2d, y2d = ctx.saved_tensors
        return swiglu_bwd_ref(x2d, y2d, g)


def _rows(x):
    """x as [R, H] with a unit column stride (a view where it can be)."""
    x2d = x.reshape(-1, x.shape[-1])
    return x2d if x2d.stride(-1) == 1 else x2d.contiguous()


def fused_bias_act(x, bias=None, act_method="gelu"):
    """`act(x + bias)` over the last axis of x (any leading shape);
    "swiglu" / "geglu" halve the last axis. Differentiable in x and
    bias."""
    shape = x.shape
    _check_act(act_method, shape[-1])
    if bias is None:
        bias = torch.zeros((shape[-1],), dtype=x.dtype, device=x.device)
    y = _BiasAct.apply(_rows(x), bias, act_method)
    return y.reshape(*shape[:-1], y.shape[-1])


def swiglu(x, y=None):
    """`silu(x) * y` (any leading shape, x and y alike); with `y=None` the
    halves of x's last axis. Differentiable in x and y."""
    if y is None:
        return fused_bias_act(x, None, "swiglu")
    shape = x.shape
    return _Swiglu.apply(_rows(x), _rows(y)).reshape(shape)
