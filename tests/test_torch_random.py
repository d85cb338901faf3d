"""Seeded draws on both packages: after the same `paddle.seed`, the
port's `rand`, `uniform` and `randint` give the JAX package's bits
(threefry in the partitionable mode, mantissa-filled floats, randint's
two draws), draw after draw, in every float width and both integer
widths; `randn` and `normal` go through `torch.erfinv` and agree within
an f32 tolerance (atol 1e-5: a few ulps of values up to ~5); the
generator's `(seed, counter)` state round-trips through
`get_rng_state` / `set_rng_state` in both."""
import numpy as np
import torch
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle

from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401


def _both(fn, seed):
    out = []
    for p in (jpaddle, tpaddle):
        p.seed(seed)
        out.append(fn(p))
    return out


def _bits(t):
    a = np.asarray(t.numpy())
    return a.view(f"uint{a.dtype.itemsize * 8}") if a.dtype.kind in "fV" \
        else a


@pytest.mark.parametrize("seed", [0, 42, 2 ** 40 + 7])
@pytest.mark.parametrize("dtype", ["float32", "float64", "float16",
                                   "bfloat16"])
def test_rand_and_uniform_bits(seed, dtype):
    def draws(p):
        return [p.rand([3, 5], dtype=dtype), p.rand([7], dtype=dtype),
                p.uniform([4, 4], dtype=dtype, min=-2.0, max=3.0)]
    want, got = _both(draws, seed)
    for w, g in zip(want, got):
        assert g.dtype.name == w.dtype.name and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
@pytest.mark.parametrize("low,high", [(0, 5), (-3, 1000), (7, 7),
                                      (0, 2 ** 31 - 1)])
def test_randint_bits(seed, dtype, low, high):
    def draws(p):
        return [p.randint(low, high, [64], dtype=dtype),
                p.randint(low, high, [2, 3], dtype=dtype)]
    want, got = _both(draws, seed)
    for w, g in zip(want, got):
        assert g.dtype.name == dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_randint_span_past_2_31_and_one_bound():
    want, got = _both(lambda p: [p.randint(-2 ** 40, 2 ** 40, [32]),
                                 p.randint(10, shape=[16])], 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("low,high", [(0, 2 ** 62 + 1), (-2 ** 62, 2 ** 62 + 3),
                                      (-2 ** 63, 2 ** 63 - 1)])
def test_randint_spans_past_2_62(low, high):
    """Spans below 2^63, past it and 2^64 - 1: the port reduces JAX's
    wrapping uint64 arithmetic in 32-bit words."""
    want, got = _both(lambda p: [p.randint(low, high, [256])], 11)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


@pytest.mark.parametrize("seed", [0, 9])
def test_randn_and_normal_within_tolerance(seed):
    def draws(p):
        return [p.randn([256]), p.normal(1.5, 2.0, [64]),
                p.randn([8], dtype="float64")]
    want, got = _both(draws, seed)
    for w, g in zip(want, got):
        assert g.dtype.name == w.dtype.name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def _ulps(w, g):
    return np.abs(_bits(w).astype(np.int64) - _bits(g).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 9, 77])
def test_randn_float64_xla_bits(seed):
    """float64 normal draws go through XLA's own ErfInv polynomial and
    log1p (`framework/random.py` `erf_inv`), whose `log(1 + x)` past
    sqrt(2) - 1 is the C library's `log`, as XLA's CPU backend calls it
    (`xla_log`): every draw has JAX's bits."""
    want, got = _both(lambda p: [p.randn([2000], dtype="float64"),
                                 p.randn([8], dtype="float64")], seed)
    for w, g in zip(want, got):
        assert _ulps(w, g).max() == 0


@pytest.mark.parametrize("seed", [0, 9, 77])
def test_randn_float32_xla_bits(seed):
    """float32 draws: the large-argument branch of log1p is XLA's
    float32 Cephes `log` (`xla_log`), which still rounds otherwise than
    XLA's emitted code in about 4 of 10,000 arguments (ROADMAP Queue C:
    seed 0, element 433 of 2,000): at most 5 of the 2,256 draws differ,
    by at most 3 ulps."""
    want, got = _both(lambda p: [p.randn([2000]), p.randn([256])], seed)
    d = np.concatenate([_ulps(w, g) for w, g in zip(want, got)])
    assert d.max() <= 3 and (d > 0).sum() <= 5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xla_log_against_jnp_log(dtype):
    """`xla_log` on 100,000 values over six decades against `jnp.log`:
    float64 bit-equal (the C library's `log`), float32 at most 0.1 %
    one ulp apart (the residue Queue C names)."""
    import jax.numpy as jnp
    from paddle_tpu_torch.framework.random import xla_log

    x = np.random.default_rng(2).uniform(1e-3, 1e3, 100_000).astype(dtype)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = xla_log(torch.from_numpy(x)).numpy()
    d = np.abs(want.view(f"int{want.itemsize * 8}").astype(np.int64)
               - got.view(f"int{got.itemsize * 8}").astype(np.int64))
    if dtype == "float64":
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_rng_state_round_trip():
    for p in (jpaddle, tpaddle):
        p.seed(3)
        p.rand([2])
    assert tpaddle.get_rng_state() == jpaddle.get_rng_state() == [(3, 1)]
    state = tpaddle.get_rng_state()
    a = tpaddle.rand([5])
    tpaddle.set_rng_state(state)
    np.testing.assert_array_equal(tpaddle.rand([5]).numpy(), a.numpy())
    jpaddle.set_rng_state(state)
    np.testing.assert_array_equal(jpaddle.rand([5]).numpy(), a.numpy())
