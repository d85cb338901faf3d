"""paddle.signal: the port of `paddle_tpu/signal.py` (`frame`,
`overlap_add`, `stft`, `istft`), differentiable ops of the port's
dispatcher with the JAX package's semantics:
- `frame` slices overlapping frames along the last axis (frames after
  it, `[..., frame_length, n_frames]`) or the first (`[frame_length,
  n_frames, ...]`); `overlap_add` sums them back at `hop_length`.
- `stft`: the window (ones by default) centre-padded to `n_fft`, the
  signal padded by n_fft // 2 each side in `pad_mode` when `center`,
  frames times the window, `rfft` (onesided, real input only) or `fft`,
  divided by sqrt(n_fft) when `normalized`; `[..., freq, frames]`.
- `istft`: the inverse transform of each frame times the window,
  overlap-added and divided by the summed squared window where that sum
  exceeds 1e-11, the centre padding trimmed, cut to `length`.
The ValueErrors are the JAX package's.
"""
from __future__ import annotations

import math

import torch

from .core import dispatch
from .core.tensor import Tensor
from .ops._helpers import as_tensor

__all__ = ["frame", "overlap_add", "stft", "istft"]


def _frame(x, *, frame_length, hop_length, last):
    if last:
        return x.unfold(-1, frame_length, hop_length).transpose(-1, -2)
    return torch.movedim(x.unfold(0, frame_length, hop_length), -1, 0)


dispatch.register_op("signal_frame", _frame)


def frame(x, frame_length, hop_length, axis=-1, name=None):
    x = as_tensor(x)
    if frame_length <= 0 or hop_length <= 0:
        raise ValueError(
            f"frame_length ({frame_length}) and hop_length ({hop_length}) "
            "must be positive")
    last = axis in (-1, x.ndim - 1)
    n = x._data.shape[-1 if last else 0]
    if frame_length > n:
        raise ValueError(
            f"frame_length ({frame_length}) exceeds signal length ({n})")
    return dispatch.apply("signal_frame", [x], {
        "frame_length": int(frame_length), "hop_length": int(hop_length),
        "last": last})


def _overlap(frames, hop):
    """Sum frames [..., F, L] at offsets f * hop -> [..., (F-1) hop + L]
    (torch's `fold` as a 1-D col2im)."""
    lead, (f, length) = frames.shape[:-2], frames.shape[-2:]
    out_len = (f - 1) * hop + length
    cols = frames.reshape(-1, f, length).transpose(1, 2)
    out = torch.nn.functional.fold(cols, (1, out_len), (1, length),
                                   stride=(1, hop))
    return out.reshape(lead + (out_len,))


def _overlap_add(x, *, hop_length, last):
    if not last:                          # [L, F, ...] -> [..., L, F]
        x = torch.movedim(torch.movedim(x, 0, -1), 0, -1)
    real = not x.is_complex()
    frames = x.transpose(-1, -2)
    if real:
        out = _overlap(frames, hop_length)
    else:
        out = torch.complex(_overlap(frames.real, hop_length),
                            _overlap(frames.imag, hop_length))
    return out if last else torch.movedim(out, -1, 0)


dispatch.register_op("signal_overlap_add", _overlap_add)


def overlap_add(x, hop_length, axis=-1, name=None):
    x = as_tensor(x)
    if hop_length <= 0:
        raise ValueError(f"hop_length ({hop_length}) must be positive")
    return dispatch.apply("signal_overlap_add", [x], {
        "hop_length": int(hop_length), "last": axis in (-1, x.ndim - 1)})


_PAD = {"reflect": "reflect", "constant": "constant", "edge": "replicate",
        "replicate": "replicate", "wrap": "circular", "circular": "circular"}


def _pad_window(w, n_fft):
    if w.shape[0] < n_fft:
        lpad = (n_fft - w.shape[0]) // 2
        w = torch.nn.functional.pad(w, (lpad, n_fft - w.shape[0] - lpad))
    return w


def _stft(x, w, *, n_fft, hop_length, center, pad_mode, normalized,
          onesided):
    w = _pad_window(w, n_fft)
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]),
                                    (pad, pad), mode=_PAD[pad_mode])
        x = x.reshape(lead + x.shape[-1:])
    frames = x.unfold(-1, n_fft, hop_length) * w
    spec = torch.fft.rfft(frames, dim=-1) if onesided \
        else torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / math.sqrt(n_fft)
    return spec.transpose(-1, -2)


dispatch.register_op("signal_stft", _stft)


def _window(window, win_length, device):
    if window is None:
        return Tensor._wrap(torch.ones((win_length,), dtype=torch.float32,
                                       device=device))
    w = as_tensor(window)
    if tuple(w._data.shape) != (win_length,):
        raise ValueError(
            f"window must be a 1-D tensor of size win_length "
            f"({win_length}), got {tuple(w._data.shape)}")
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """The short-time Fourier transform, `[..., n_fft // 2 + 1, frames]`
    (onesided) or `[..., n_fft, frames]`, complex."""
    x = as_tensor(x)
    hop_length = int(hop_length) if hop_length is not None else n_fft // 4
    win_length = int(win_length) if win_length is not None else int(n_fft)
    if hop_length <= 0:
        raise ValueError(f"hop_length ({hop_length}) must be positive")
    if not win_length <= n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft "
                         f"({n_fft})")
    if x._data.is_complex() and onesided:
        raise ValueError("onesided must be False for complex input")
    w = _window(window, win_length, x._data.device)
    return dispatch.apply("signal_stft", [x, w], {
        "n_fft": int(n_fft), "hop_length": hop_length, "center": bool(center),
        "pad_mode": str(pad_mode), "normalized": bool(normalized),
        "onesided": bool(onesided)})


def _istft(x, w, *, n_fft, hop_length, center, normalized, onesided, length,
           return_complex):
    w = _pad_window(w, n_fft)
    spec = x.transpose(-1, -2)                        # [..., F, freq]
    if normalized:
        spec = spec * math.sqrt(n_fft)
    if onesided:
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(spec, dim=-1)
        if not return_complex:
            frames = frames.real
    wf = w.to(frames.real.dtype)
    frames = frames * wf
    f = frames.shape[-2]
    out_len = (f - 1) * hop_length + n_fft
    if frames.is_complex():
        sig = torch.complex(_overlap(frames.real, hop_length),
                            _overlap(frames.imag, hop_length))
    else:
        sig = _overlap(frames, hop_length)
    env = _overlap((wf * wf).expand(f, n_fft), hop_length)
    sig = sig / torch.where(env > 1e-11, env, torch.ones_like(env))
    if center:
        sig = sig[..., n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        sig = sig[..., :length]
    return sig


dispatch.register_op("signal_istft", _istft)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse STFT: the least-squares overlap-add sum(w frame) /
    sum(w^2)."""
    x = as_tensor(x)
    hop_length = int(hop_length) if hop_length is not None else n_fft // 4
    win_length = int(win_length) if win_length is not None else int(n_fft)
    if not x._data.is_complex():
        raise ValueError("istft expects a complex STFT tensor")
    n_freq = x._data.shape[-2]
    expect = n_fft // 2 + 1 if onesided else n_fft
    if n_freq != expect:
        raise ValueError(
            f"input freq dim ({n_freq}) does not match n_fft ({n_fft}) with "
            f"onesided={onesided} (expected {expect})")
    w = _window(window, win_length, x._data.device)
    return dispatch.apply("signal_istft", [x, w], {
        "n_fft": int(n_fft), "hop_length": hop_length, "center": bool(center),
        "normalized": bool(normalized), "onesided": bool(onesided),
        "length": None if length is None else int(length),
        "return_complex": bool(return_complex)})
