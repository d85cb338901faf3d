"""`paddle.fft` and `paddle.signal` in the port against the JAX package:
- output dtypes of every transform on bfloat16, float16, float32 and
  float64 input (jnp.fft's off the TPU: complex64 from the half and
  single floats, complex128 from float64);
- `hfftn` / `ihfftn` with and without `s` (JAX's per-axis composition),
  every `norm`, and the ValueError of a bad one;
- `stft` / `istft` round trips and each ValueError of `signal.py`;
- the gradient of losses through `fftn(x, axes=(1, 2)).real()` and the
  other transforms, held to `jax.grad` of the same `jnp.fft`
  expression, float64 within 1e-10 and float32 within 1e-5;
- the closed divergence: JAX's eager `paddle.fft` detaches its output,
  the port's keeps the tape (ROADMAP Queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle

from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "float64": dict(rtol=1e-10, atol=1e-10)}
TOL["complex64"], TOL["complex128"] = TOL["float32"], TOL["float64"]

RNG = np.random.default_rng(21)
X = RNG.standard_normal((2, 6, 8))
Z = X + 1j * RNG.standard_normal((2, 6, 8))


def _t(p, a, dtype):
    if dtype == "bfloat16":
        return p.to_tensor(a.astype(np.float32)).astype("bfloat16")
    return p.to_tensor(a.astype(dtype), dtype=dtype)


def _np(t):
    return np.asarray(t.numpy())


def _held(want, got, label):
    assert (got.dtype, got.shape) == (want.dtype, want.shape), label
    np.testing.assert_allclose(got, want, err_msg=label,
                               **TOL[str(want.dtype)])


ONE_D = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]
N_D = ["fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2", "fftn",
       "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "float64"])
def test_output_dtypes(dtype):
    """jnp.fft's dtypes; where JAX's real-to-complex transforms refuse a
    half-float input (XLA's RFFT takes float32 / float64), the port
    transforms its float32 upcast, as JAX's complex transforms do."""
    for name in ONE_D + N_D:
        got = getattr(tpaddle.fft, name)(_t(tpaddle, X, dtype))
        try:
            want = getattr(jpaddle.fft, name)(_t(jpaddle, X, dtype))
        except ValueError:
            assert dtype in ("bfloat16", "float16"), name
            want = getattr(jpaddle.fft, name)(_t(jpaddle, X, "float32"))
        assert got.dtype.name == want.dtype.name, (name, dtype)
        assert got.shape == want.shape, (name, dtype)


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
@pytest.mark.parametrize("name", ONE_D + N_D)
def test_transforms_and_norms(name, norm):
    src = Z if name in ("fft", "ifft", "irfft", "hfft", "fft2", "ifft2",
                        "irfft2", "hfft2", "fftn", "ifftn", "irfftn",
                        "hfftn") else X
    dtype = "complex128" if src is Z else "float64"
    out = [getattr(p.fft, name)(p.to_tensor(src, dtype=dtype), norm=norm)
           for p in (jpaddle, tpaddle)]
    _held(_np(out[0]), _np(out[1]), f"{name} {norm}")


@pytest.mark.parametrize("name", ["hfftn", "ihfftn"])
@pytest.mark.parametrize("s,axes", [(None, None), ((4, 6), (1, 2)),
                                    ((3, 5, 10), None), (None, (0, 2))])
def test_hermitian_nd_with_s(name, s, axes):
    src = Z if name == "hfftn" else X
    dtype = "complex128" if src is Z else "float64"
    out = [getattr(p.fft, name)(p.to_tensor(src, dtype=dtype), s=s,
                                axes=axes) for p in (jpaddle, tpaddle)]
    _held(_np(out[0]), _np(out[1]), f"{name} s={s} axes={axes}")


def test_bad_norm_raises():
    for p in (jpaddle, tpaddle):
        for name in ("fft", "rfftn", "ihfft2"):
            with pytest.raises(ValueError):
                getattr(p.fft, name)(p.to_tensor(X), norm="unitary")


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_frequencies_and_shifts(dtype):
    for p_fn in ("fftfreq", "rfftfreq"):
        out = [getattr(p.fft, p_fn)(9, d=0.3, dtype=dtype)
               for p in (jpaddle, tpaddle)]
        _held(_np(out[0]), _np(out[1]), p_fn)
    for name in ("fftshift", "ifftshift"):
        for axes in (None, (1,), (0, 2)):
            out = [getattr(p.fft, name)(p.to_tensor(X, dtype="float64"),
                                        axes=axes) for p in (jpaddle,
                                                             tpaddle)]
            _held(_np(out[0]), _np(out[1]), f"{name} {axes}")


SIG = RNG.standard_normal((2, 400))


@pytest.mark.parametrize("n_fft,hop,win,center,normalized", [
    (64, 16, None, True, False), (64, 16, 48, True, True),
    (32, 8, None, False, False), (50, 10, 40, True, False)])
def test_stft_istft_round_trip(n_fft, hop, win, center, normalized):
    win_len = win or n_fft
    window = np.hanning(win_len + 1)[:-1]

    def run(p):
        x = p.to_tensor(SIG, dtype="float64")
        w = p.to_tensor(window, dtype="float64")
        spec = p.signal.stft(x, n_fft, hop, win, w, center=center,
                             normalized=normalized)
        back = p.signal.istft(spec, n_fft, hop, win, w, center=center,
                              normalized=normalized, length=SIG.shape[-1]
                              if center else None)
        return spec, back

    (js, jb), (ts, tb) = (run(p) for p in (jpaddle, tpaddle))
    _held(_np(js), _np(ts), "stft")
    _held(_np(jb), _np(tb), "istft")
    if center:
        np.testing.assert_allclose(_np(tb), SIG, rtol=1e-9, atol=1e-9)


def test_stft_two_sided_and_complex():
    def run(p):
        z = p.to_tensor(Z[0, :, :].reshape(-1), dtype="complex128")
        spec = p.signal.stft(z, 16, 4, onesided=False)
        back = p.signal.istft(spec, 16, 4, onesided=False,
                              return_complex=True)
        return spec, back

    (js, jb), (ts, tb) = (run(p) for p in (jpaddle, tpaddle))
    _held(_np(js), _np(ts), "stft two-sided")
    _held(_np(jb), _np(tb), "istft complex")


@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_and_overlap_add(axis):
    a = RNG.standard_normal((20, 3)) if axis == 0 else \
        RNG.standard_normal((3, 20))

    def run(p):
        f = p.signal.frame(p.to_tensor(a, dtype="float64"), 6, 4, axis=axis)
        return f, p.signal.overlap_add(f, 4, axis=axis)

    (jf, jo), (tf, to) = (run(p) for p in (jpaddle, tpaddle))
    _held(_np(jf), _np(tf), "frame")
    _held(_np(jo), _np(to), "overlap_add")


SIGNAL_ERRORS = {
    "frame_length": lambda p, x: p.signal.frame(x, 0, 4),
    "frame_hop": lambda p, x: p.signal.frame(x, 4, -1),
    "frame_too_long": lambda p, x: p.signal.frame(x, 500, 4),
    "overlap_hop": lambda p, x: p.signal.overlap_add(x, 0),
    "stft_hop": lambda p, x: p.signal.stft(x, 64, 0),
    "stft_win_length": lambda p, x: p.signal.stft(x, 64, 16, 80),
    "stft_window_shape": lambda p, x: p.signal.stft(
        x, 64, 16, 32, p.ones([31])),
    "stft_complex_onesided": lambda p, x: p.signal.stft(
        p.to_tensor(Z[0, 0]), 4, 2),
    "istft_real": lambda p, x: p.signal.istft(x, 64),
    "istft_freq": lambda p, x: p.signal.istft(
        p.signal.stft(x, 64, 16), 32),
    "istft_window_shape": lambda p, x: p.signal.istft(
        p.signal.stft(x, 64, 16), 64, 16, 64, p.ones([63])),
}


@pytest.mark.parametrize("case", sorted(SIGNAL_ERRORS))
def test_signal_value_errors(case):
    for p in (jpaddle, tpaddle):
        with pytest.raises(ValueError):
            SIGNAL_ERRORS[case](p, p.to_tensor(SIG, dtype="float64"))


def _port_grad(loss_fn, a, dtype):
    x = tpaddle.to_tensor(a, dtype=dtype, stop_gradient=False)
    loss_fn(tpaddle, x).backward()
    return _np(x.grad)


LOSSES = {
    "fftn_real": (lambda p, x: (p.fft.fftn(x, axes=(1, 2)).real() * W).sum(),
                  lambda x: (jnp.fft.fftn(x, axes=(1, 2)).real * W).sum()),
    "rfft_abs": (lambda p, x: p.fft.rfft(x).abs().sum(),
                 lambda x: jnp.abs(jnp.fft.rfft(x)).sum()),
    "irfft2_of_rfft2": (
        lambda p, x: (p.fft.irfft2(p.fft.rfft2(x) * 1.5, s=(6, 8)) * W)
        .sum(),
        lambda x: (jnp.fft.irfft2(jnp.fft.rfft2(x) * 1.5, s=(6, 8)) * W)
        .sum()),
    "hfft_ortho": (lambda p, x: (p.fft.hfft(x, norm="ortho") ** 2).sum(),
                   lambda x: (jnp.fft.hfft(x, norm="ortho") ** 2).sum()),
    "ifftn_imag": (lambda p, x: (p.fft.ifftn(x).imag() * W).sum(),
                   lambda x: (jnp.fft.ifftn(x).imag * W).sum()),
}
W = RNG.standard_normal((2, 6, 8))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_gradients_match_jax_grad(loss, dtype):
    port_fn, jax_fn = LOSSES[loss]
    want = np.asarray(jax.grad(lambda x: jax_fn(x))(jnp.asarray(
        X.astype(dtype))))
    if dtype == "float32":
        want = want.astype(np.float32)
    got = _port_grad(port_fn, X, dtype)
    _held(want, got, loss)


def test_eager_divergence_is_pinned():
    """`(fftn(x).real().sum() + (x * x).sum()).backward()`: JAX's eager
    fft stops gradient (x.grad is 2x alone); the port differentiates the
    transform too, as JAX's traced path does."""
    grads = {}
    for p in (jpaddle, tpaddle):
        x = p.to_tensor(X.astype(np.float32), stop_gradient=False)
        f = p.fft.fftn(x)
        assert f.stop_gradient is (p is jpaddle)
        (f.real().sum() + (x * x).sum()).backward()
        grads[p.__name__] = _np(x.grad)
    two_x = 2 * X.astype(np.float32)
    np.testing.assert_allclose(grads["paddle_tpu"], two_x, rtol=1e-6)
    fft_grad = np.asarray(jax.grad(lambda x: jnp.fft.fftn(x).real.sum())(
        jnp.asarray(X.astype(np.float32))))
    np.testing.assert_allclose(grads["paddle_tpu_torch"], two_x + fft_grad,
                               **TOL["float32"])
