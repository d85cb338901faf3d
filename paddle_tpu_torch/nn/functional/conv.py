"""Convolutions: the port of `paddle_tpu/nn/functional/conv.py`.

The JAX package computes each one with `lax.conv_general_dilated`, not a
Pallas kernel, so the port calls `torch.nn.functional.conv{1,2,3}d`
(cuDNN on the card) and gives it JAX's semantics:
- padding (`_norm_padding`, `conv.py:31-51`): `"SAME"` and `"VALID"`,
  an int, one per spatial axis, per-side pairs, or paddle's per-axis
  lists (with or without the batch and channel axes). `"SAME"` gets the
  pads of `lax.padtype_to_pads` (the odd pixel at the end), and an
  asymmetric padding is applied by an explicit zero pad before a conv
  with none;
- NHWC / NDHWC layouts are moved to channels-first and back; weights stay
  `[out, in / groups, *k]` either way;
- a transposed conv (weight `[in, out / groups, *k]`) is the JAX
  package's conv over the input dilated by the stride (`lhs_dilation`),
  with the kernel flipped and its in / out axes swapped, and pads
  `d * (k - 1) - p` each side plus `output_padding` at the end
  (`conv.py:128-220`). The dilated input is built by scattering into
  zeros, so groups, dilation and `output_size` follow the same path.
  `"SAME"` / `"VALID"` are taken at stride 1 only: `lax.conv` refuses a
  string padding with an input dilation, and so does the port.
"""
from __future__ import annotations

import torch

from ...core import dispatch
from ...ops._helpers import as_tensor

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


def _tuple_n(v, n):
    if isinstance(v, (list, tuple)):
        v = tuple(int(x) for x in v)
        return v * n if len(v) == 1 else v
    return (int(v),) * n


def _norm_padding(padding, n, data_format):
    """paddle's padding spec -> per-side pairs, or "SAME" / "VALID"."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return ((padding, padding),) * n
    padding = list(padding)
    if len(padding) == n:
        if all(isinstance(p, (list, tuple)) for p in padding):
            return tuple(tuple(int(x) for x in p) for p in padding)
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    if len(padding) == 2 * (n + 2):  # per-axis pairs with batch / channel
        spatial = padding[2:2 + 2 * n] if data_format.endswith("C") \
            else padding[4:4 + 2 * n]
        return tuple((int(spatial[2 * i]), int(spatial[2 * i + 1]))
                     for i in range(n))
    raise ValueError(f"bad padding spec {padding}")


def _same_pads(in_sizes, kernel, stride, dilation):
    """`lax.padtype_to_pads(..., "SAME")` for a dilated kernel."""
    pads = []
    for s, k, st, d in zip(in_sizes, kernel, stride, dilation):
        eff = d * (k - 1) + 1
        out = -(-s // st)
        total = max((out - 1) * st + eff - s, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _to_channels_first(x, n, channel_last):
    return torch.movedim(x, -1, 1) if channel_last else x


def _from_channels_first(y, channel_last):
    return torch.movedim(y, 1, -1) if channel_last else y


def _pad_lo_hi(x, pads):
    """Zero-pad the trailing spatial axes by per-side `pads`; returns the
    tensor and the symmetric padding left for the conv call."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return torch.nn.functional.pad(x, flat), (0,) * len(pads)


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}


def _conv_fn(x, w, b=None, *, stride, padding, dilation, groups, n,
             data_format):
    channel_last = data_format.endswith("C")
    x = _to_channels_first(x, n, channel_last)
    if padding == "VALID":
        pads = ((0, 0),) * n
    elif padding == "SAME":
        pads = _same_pads(x.shape[2:], w.shape[2:], stride, dilation)
    else:
        pads = padding
    x, sym = _pad_lo_hi(x, pads)
    y = _CONV[n](x, w, b, stride=stride, padding=sym, dilation=dilation,
                 groups=groups)
    return _from_channels_first(y, channel_last)


for _n in (1, 2, 3):
    dispatch.register_op(
        f"conv{_n}d", (lambda n: lambda x, w, b, **kw: _conv_fn(
            x, w, b, n=n, **kw))(_n))
    dispatch.register_op(
        f"conv{_n}d_nobias", (lambda n: lambda x, w, **kw: _conv_fn(
            x, w, None, n=n, **kw))(_n))


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    x, weight = as_tensor(x), as_tensor(weight)
    attrs = {"stride": _tuple_n(stride, n),
             "padding": _norm_padding(padding, n, data_format),
             "dilation": _tuple_n(dilation, n), "groups": int(groups),
             "data_format": data_format}
    if bias is None:
        return dispatch.apply(f"conv{n}d_nobias", [x, weight], attrs)
    return dispatch.apply(f"conv{n}d", [x, weight, as_tensor(bias)], attrs)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    data_format = {"NCL": "NCW", "NLC": "NWC"}.get(data_format, data_format)
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


# ---- transposed convolutions ------------------------------------------------


def _dilate(x, stride, n):
    """The input with `stride - 1` zeros between neighbours on each
    spatial axis (`lhs_dilation`)."""
    if all(s == 1 for s in stride):
        return x
    size = tuple((s - 1) * st + 1 for s, st in zip(x.shape[2:], stride))
    out = x.new_zeros(tuple(x.shape[:2]) + size)
    out[(slice(None), slice(None)) + tuple(slice(None, None, st)
                                           for st in stride)] = x
    return out


def _pad_signed(x, pads):
    """Per-side pads that may be negative (a crop), as `lax.conv`'s
    padding allows."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return torch.nn.functional.pad(x, flat)


def _conv_transpose_fn(x, w, b=None, *, stride, padding, output_padding,
                       dilation, groups, n, data_format):
    channel_last = data_format.endswith("C")
    x = _to_channels_first(x, n, channel_last)
    ksz = w.shape[2:2 + n]
    if isinstance(padding, str) and any(s != 1 for s in stride):
        raise ValueError("string padding is not implemented for a strided "
                         "transposed convolution (as in the JAX package): "
                         "give the pads")
    if padding == "VALID":
        pads = ((0, 0),) * n
    elif padding == "SAME":
        pads = _same_pads(x.shape[2:], ksz, (1,) * n, dilation)
    else:
        pads = []
        for i in range(n):
            eff = dilation[i] * (ksz[i] - 1) + 1
            pads.append((eff - 1 - padding[i][0],
                         eff - 1 - padding[i][1] + output_padding[i]))
    xd = _pad_signed(_dilate(x, stride, n), pads)
    # [in, out/g, *k] -> per group [out/g, in/g, *k], spatially flipped
    cin = w.shape[0]
    wg = w.reshape((groups, cin // groups) + tuple(w.shape[1:]))
    wt = torch.flip(wg.transpose(1, 2), dims=tuple(range(3, 3 + n)))
    wt = wt.reshape((groups * w.shape[1], cin // groups) + tuple(ksz))
    y = _CONV[n](xd, wt, b, stride=1, padding=0, dilation=dilation,
                 groups=groups)
    return _from_channels_first(y, channel_last)


for _n in (1, 2, 3):
    dispatch.register_op(
        f"conv{_n}d_transpose", (lambda n: lambda x, w, b, **kw:
                                 _conv_transpose_fn(x, w, b, n=n, **kw))(_n))
    dispatch.register_op(
        f"conv{_n}d_transpose_nobias", (lambda n: lambda x, w, **kw:
                                        _conv_transpose_fn(x, w, None, n=n,
                                                           **kw))(_n))


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size=None):
    x, weight = as_tensor(x), as_tensor(weight)
    stride = _tuple_n(stride, n)
    dilation = _tuple_n(dilation, n)
    output_padding = _tuple_n(output_padding, n)
    pad_spec = _norm_padding(padding, n, data_format)
    if output_size is not None:
        # the output_padding that gives the requested size
        output_size = _tuple_n(output_size, n)
        in_sp = x.shape[1:1 + n] if data_format.endswith("C") \
            else x.shape[2:2 + n]
        k = weight.shape[2:2 + n]
        base_pad = pad_spec if not isinstance(pad_spec, str) \
            else ((0, 0),) * n
        output_padding = tuple(
            int(output_size[i] - ((in_sp[i] - 1) * stride[i]
                                  - base_pad[i][0] - base_pad[i][1]
                                  + dilation[i] * (k[i] - 1) + 1))
            for i in range(n))
    attrs = {"stride": stride, "padding": pad_spec,
             "output_padding": output_padding, "dilation": dilation,
             "groups": int(groups), "data_format": data_format}
    if bias is None:
        return dispatch.apply(f"conv{n}d_transpose_nobias", [x, weight],
                              attrs)
    return dispatch.apply(f"conv{n}d_transpose",
                          [x, weight, as_tensor(bias)], attrs)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    data_format = {"NCL": "NCW", "NLC": "NWC"}.get(data_format, data_format)
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size)
