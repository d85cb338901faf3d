"""paddle.fft: the port of `paddle_tpu/fft.py` over `torch.fft`.

Every transform of the JAX package (c2c, r2c, c2r and hermitian, 1-D,
2-D and N-D), the frequency helpers and the shifts, with its semantics:
- `norm` None means "backward"; any value but "forward", "backward" or
  "ortho" raises ValueError.
- Dtypes as jnp.fft gives them off the TPU: a real bfloat16 / float16
  input is transformed in float32 (complex64 out), float64 in float64
  (complex128 out), an integer or bool input as float64.
- `hfftn` / `ihfftn` compose per axis as the JAX package's do: c2c
  `fftn` over the leading axes and a 1-D `hfft` over the last (and the
  inverse in the other order), not torch's own N-D hermitian transform.
- `fftfreq` / `rfftfreq` are float64 unless `dtype` is given.

Deliberate divergence: the transforms are ops of the port's dispatcher,
so they are differentiable and lazy mode records them. The JAX package's
eager `paddle.fft.*` return a fresh Tensor that stops gradient, and only
its traced path (`jit`, `functional_call`) differentiates them; a model
that trains through `paddle.fft` (FNet) needs the traced behaviour, and
the port gives it in eager mode too.
"""
from __future__ import annotations

import torch

from .core import dispatch
from .core.tensor import Tensor
from .framework import dtype as dtype_mod
from .framework.place import expected_device
from .ops._helpers import as_tensor

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
           "fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2",
           "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn",
           "fftfreq", "rfftfreq", "fftshift", "ifftshift"]


def _norm(norm):
    if norm is None:
        return "backward"
    if norm not in ("forward", "backward", "ortho"):
        raise ValueError(f"invalid norm {norm!r}; expected 'forward', "
                         "'backward' or 'ortho'")
    return norm


def _widen(x):
    """jnp.fft's input dtype: half floats as float32, integers and bools
    as float64."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    if not dtype_mod.is_inexact(x.dtype):
        return x.double()
    return x


def _tuple(v):
    return None if v is None else tuple(int(a) for a in v)


def _hfftn(x, *, s, dim, norm):
    dim = tuple(range(x.dim())) if dim is None else dim
    if len(dim) > 1:
        x = torch.fft.fftn(x, s=None if s is None else s[:-1], dim=dim[:-1],
                           norm=norm)
    return torch.fft.hfft(x, n=None if s is None else s[-1], dim=dim[-1],
                          norm=norm)


def _ihfftn(x, *, s, dim, norm):
    dim = tuple(range(x.dim())) if dim is None else dim
    out = torch.fft.ihfft(x, n=None if s is None else s[-1], dim=dim[-1],
                          norm=norm)
    if len(dim) > 1:
        out = torch.fft.ifftn(out, s=None if s is None else s[:-1],
                              dim=dim[:-1], norm=norm)
    return out


_ONE_D = {n: getattr(torch.fft, n)
          for n in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft")}
_N_D = {"fftn": torch.fft.fftn, "ifftn": torch.fft.ifftn,
        "rfftn": torch.fft.rfftn, "irfftn": torch.fft.irfftn,
        "hfftn": _hfftn, "ihfftn": _ihfftn}
for _n, _f in _ONE_D.items():
    dispatch.register_op(
        "fft_" + _n, lambda x, *, n, axis, norm, _f=_f: _f(
            _widen(x), n=n, dim=axis, norm=norm))
for _n, _f in _N_D.items():
    dispatch.register_op(
        "fft_" + _n, lambda x, *, s, axes, norm, _f=_f: _f(
            _widen(x), s=s, dim=axes, norm=norm))


def _one_d(op):
    def api(x, n=None, axis=-1, norm=None, name=None):
        return dispatch.apply("fft_" + op, [as_tensor(x)], {
            "n": None if n is None else int(n), "axis": int(axis),
            "norm": _norm(norm)})

    api.__name__ = op
    return api


def _n_d(op):
    def api(x, s=None, axes=None, norm=None, name=None):
        return dispatch.apply("fft_" + op, [as_tensor(x)], {
            "s": _tuple(s), "axes": _tuple(axes), "norm": _norm(norm)})

    api.__name__ = op
    return api


fft = _one_d("fft")
ifft = _one_d("ifft")
rfft = _one_d("rfft")
irfft = _one_d("irfft")
hfft = _one_d("hfft")
ihfft = _one_d("ihfft")
fftn = _n_d("fftn")
ifftn = _n_d("ifftn")
rfftn = _n_d("rfftn")
irfftn = _n_d("irfftn")
hfftn = _n_d("hfftn")
ihfftn = _n_d("ihfftn")


def _two_d(nd):
    def api(x, s=None, axes=(-2, -1), norm=None, name=None):
        return nd(x, s=s, axes=axes, norm=norm)

    api.__name__ = nd.__name__[:-1] + "2"
    return api


fft2 = _two_d(fftn)
ifft2 = _two_d(ifftn)
rfft2 = _two_d(rfftn)
irfft2 = _two_d(irfftn)
hfft2 = _two_d(hfftn)
ihfft2 = _two_d(ihfftn)


def _freq(tfn, n, d, dtype):
    out = tfn(int(n), d=float(d), dtype=torch.float64,
              device=expected_device())
    if dtype is not None:
        out = out.to(dtype_mod.to_torch(dtype))
    return Tensor._wrap(out)


def fftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


dispatch.register_op("fft_fftshift", lambda x, *, axes: torch.fft.fftshift(
    x, dim=axes))
dispatch.register_op("fft_ifftshift", lambda x, *, axes: torch.fft.ifftshift(
    x, dim=axes))


def fftshift(x, axes=None, name=None):
    return dispatch.apply("fft_fftshift", [as_tensor(x)],
                          {"axes": _tuple(axes) if not isinstance(axes, int)
                           else axes})


def ifftshift(x, axes=None, name=None):
    return dispatch.apply("fft_ifftshift", [as_tensor(x)],
                          {"axes": _tuple(axes) if not isinstance(axes, int)
                           else axes})
