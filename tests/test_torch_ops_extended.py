"""The extended op surface (`paddle_tpu_torch/ops/extended.py`) on the
cases the generic harness does not reach, each on both packages:
- `cummax` / `cummin`, `mode` and `kthvalue` on inputs full of ties
  (values and indices equal to JAX's);
- `take` in each mode, negative indices wrapping once, and the index
  ops raising on an index JAX would clamp or drop (the port's closed
  index rule);
- `view` to another dtype (narrowing, widening, same width) and
  `as_strided`, bit for bit;
- the seeded draws: `poisson` and `binomial` (the `jax.random`
  rejection loops), `geometric_`, `bernoulli_`, `uniform_`,
  `randint_like` and `top_p_sampling`'s ids bit-equal to JAX;
  `standard_gamma` within float64's tolerance and by its moments; `normal_`,
  `log_normal_`, `standard_normal`, `log_normal`, `exponential_` and
  `cauchy_` within float32's tolerance (their float32 erfinv / log1p /
  tan round differently in XLA's CPU kernels and torch's; the uniform
  bits under them are equal);
- `finfo` / `iinfo` fields, `set_printoptions` round trips;
- every in-place form of the table: the result equal to JAX's, the
  Tensor rebound in place, and a view taken before it keeping the values
  it had (as JAX's arrays do).
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.ops import extended as jext
from paddle_tpu_torch.ops import extended as text

from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "float64": dict(rtol=1e-10, atol=1e-12)}


def _np(t):
    return np.asarray(t.numpy())


def _both(fn, seed=0):
    out = []
    for p in (jpaddle, tpaddle):
        p.seed(seed)
        r = fn(p)
        out.append([_np(t) for t in (r if isinstance(r, (list, tuple))
                                     else [r])])
    return out


def _equal(want, got):
    for w, g in zip(want, got):
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        np.testing.assert_array_equal(g, w)


def _close(want, got):
    for w, g in zip(want, got):
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        np.testing.assert_allclose(g, w, **TOL[str(w.dtype)])


def _t(p, a):
    return p.to_tensor(a, dtype=str(a.dtype))


TIES = np.array([[3, 1, 3, 2, 3, 1], [0, 0, 5, 5, 0, 5], [2, 2, 2, 2, 2, 2],
                 [4, 7, 7, 4, 7, 4]])


@pytest.mark.parametrize("op", ["cummax", "cummin"])
@pytest.mark.parametrize("dtype", ["float32", "int64"])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_cum_extremes_on_ties(op, dtype, axis):
    """The index of a tied extreme is the later one, as JAX's
    associative-scan combine (`b >= a` keeps b) decides."""
    a = TIES.astype(dtype)
    want, got = _both(lambda p: getattr(p, op)(_t(p, a), axis=axis))
    _equal(want, got)


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_mode_and_kthvalue_on_ties(keepdim, axis):
    a = TIES.astype("float32")

    def run(p):
        x = _t(p, a)
        return [*p.mode(x, axis=axis, keepdim=keepdim),
                *p.kthvalue(x, 2, axis=axis, keepdim=keepdim)]

    want, got = _both(run)
    _equal(want, got)


X12 = np.arange(12, dtype=np.float32).reshape(3, 4) * 1.5


@pytest.mark.parametrize("mode,index", [
    ("wrap", [0, 5, -1, 13, -15, 27]), ("clip", [0, 5, -1, 13, -15, 27]),
    ("raise", [0, 5, -1, -12, 11])])
def test_take_modes(mode, index):
    idx = np.array(index, np.int64).reshape(2, -1) if len(index) % 2 == 0 \
        else np.array(index, np.int64)
    want, got = _both(lambda p: p.take(_t(p, X12), _t(p, idx), mode=mode))
    _equal(want, got)


OUT_OF_RANGE = {
    "take": lambda p, x: p.take(x, p.to_tensor([0, 12])),
    "take_negative": lambda p, x: p.take(x, p.to_tensor([-13])),
    "index_add": lambda p, x: p.index_add(x, p.to_tensor([0, 4]), 1,
                                          p.ones([3, 2])),
    "index_fill": lambda p, x: p.index_fill(x, p.to_tensor([5]), 1, 0.5),
    "index_put": lambda p, x: p.index_put(
        x, (p.to_tensor([0, 3]), p.to_tensor([1, 1])),
        p.to_tensor([1.0, 2.0])),
    "masked_scatter": lambda p, x: p.masked_scatter(
        x, x > 3.0, p.to_tensor([1.0, 2.0])),
    "multiplex": lambda p, x: p.multiplex([x, x],
                                          p.to_tensor([[0], [2], [1]])),
    "as_strided": lambda p, x: p.as_strided(x, [4, 4], [3, 1]),
}


@pytest.mark.parametrize("case", sorted(OUT_OF_RANGE))
def test_index_ops_raise_out_of_range(case):
    """JAX clamps the gather or drops the scatter; the port raises."""
    fn = OUT_OF_RANGE[case]
    fn(jpaddle, jpaddle.to_tensor(X12))          # JAX runs it
    with pytest.raises((IndexError, RuntimeError)):
        fn(tpaddle, tpaddle.to_tensor(X12)).numpy()


def test_index_ops_wrap_negative_indices():
    def run(p):
        x = p.to_tensor(X12)
        return [p.index_add(x, p.to_tensor([-1, 0]), 1, p.ones([3, 2])),
                p.index_fill(x, p.to_tensor([-2]), 0, 7.0),
                p.index_put(x, (p.to_tensor([-1]), p.to_tensor([-4])),
                            p.to_tensor([9.0]), accumulate=True)]

    want, got = _both(run)
    _equal(want, got)


@pytest.mark.parametrize("src,dst", [("float32", "int32"),
                                     ("float32", "float16"),
                                     ("int8", "int32"), ("float64", "int32"),
                                     ("int32", "uint8")])
def test_view_dtype_bits(src, dst):
    a = (np.arange(24) * 37 - 300).astype(src).reshape(2, 12)
    want, got = _both(lambda p: _t(p, a).view(dst))
    _equal(want, got)


@pytest.mark.parametrize("shape,stride,offset", [
    ((3, 3), (4, 1), 0), ((2, 5), (1, 2), 1), ((4,), (3,), 2),
    ((2, 2, 2), (6, 2, 1), 2)])
def test_as_strided(shape, stride, offset):
    want, got = _both(lambda p: p.as_strided(p.to_tensor(X12), shape, stride,
                                             offset))
    _equal(want, got)


def _f(a, dtype="float32"):
    return np.asarray(a, dtype)


BIT_EQUAL_DRAWS = {
    "poisson_knuth": lambda p: p.poisson(p.to_tensor(_f(
        [[0.0, 0.5, 3.0], [9.5, 1.0, 6.0]]))),
    "poisson_rejection": lambda p: p.poisson(_t(p, _f(
        [10.0, 12.0, 40.0, 250.0, 3.0], "float64"))),
    "binomial": lambda p: p.binomial(
        p.to_tensor(np.array([5, 100, 1000, 40, 0], np.int64)),
        p.to_tensor(_f([0.3, 0.4, 0.8, 0.95, 0.5]))),
    "geometric_": lambda p: p.zeros([3, 5]).geometric_(0.3),
    "bernoulli_": lambda p: p.zeros([4, 4]).bernoulli_(0.35),
    "uniform_": lambda p: p.zeros([16], dtype="float64").uniform_(-2, 3),
    "randint_like": lambda p: p.randint_like(p.zeros([3, 4], "int32"), 2, 9),
}


@pytest.mark.parametrize("seed", [0, 77])
@pytest.mark.parametrize("name", sorted(BIT_EQUAL_DRAWS))
def test_draws_bit_equal(name, seed):
    want, got = _both(BIT_EQUAL_DRAWS[name], seed)
    _equal(want, got)


@pytest.mark.parametrize("seed", [0, 77])
def test_top_p_sampling_ids_bit_equal(seed):
    """The drawn ids (`jax.random.categorical`'s Gumbel-max) are JAX's;
    their probabilities are float32 softmax values within its
    tolerance."""
    logits = np.random.default_rng(1).standard_normal((4, 50)).astype(
        np.float32)
    (wv, wi), (gv, gi) = _both(lambda p: p.top_p_sampling(
        p.to_tensor(logits), p.to_tensor(_f([0.3, 0.7, 0.9, 1.0]))), seed)
    _equal([wi], [gi])
    _close([wv], [gv])


@pytest.mark.parametrize("seed", [0, 77])
@pytest.mark.parametrize("alpha", [[0.05, 0.3, 1.0, 2.5, 7.0, 40.0],
                                   [[0.7, 3.0], [0.01, 12.0]]])
def test_standard_gamma_within_float64(alpha, seed):
    """`jax.random.gamma`'s Marsaglia-Tsang loop on the same keys: the
    same accept / reject path, values within float64's tolerance. The
    normal draws are XLA's bits; the boost's `pow` and a few of the
    loop's products still round otherwise in the last bit (ROADMAP
    Queue C)."""
    want, got = _both(lambda p: p.standard_gamma(_t(p, _f(alpha))), seed)
    _close(want, got)


def test_standard_gamma_queue_c_element_bit_equal():
    """The element ROADMAP Queue C named: at `paddle.seed(0)` element 2
    of `standard_gamma([0.05, 0.3, 1.0, 2.5, 7.0, 40.0])` is JAX's
    0.04900077673808186, and elements 1-5 are JAX's bits."""
    alpha = _f([0.05, 0.3, 1.0, 2.5, 7.0, 40.0], "float64")
    (want,), (got,) = _both(lambda p: p.standard_gamma(_t(p, alpha)), 0)
    assert got[2] == want[2] == 0.04900077673808186
    np.testing.assert_array_equal(got[1:], want[1:])


@pytest.mark.parametrize("seed", [0, 77])
def test_standard_gamma_2000_draws_last_bit(seed):
    """2,000 float64 draws over alpha in [1, 40]: the normal draws are
    XLA's bits and `1 + x c` is fused as XLA fuses it, so at most 3 % of
    the draws differ, each in its last bits only (ROADMAP Queue C names
    the first)."""
    alpha = np.linspace(1.0, 40.0, 2000)
    (want,), (got,) = _both(lambda p: p.standard_gamma(_t(p, alpha)), seed)
    differ = want != got
    assert differ.mean() <= 0.03
    np.testing.assert_allclose(got, want, rtol=4e-15, atol=0)


@pytest.mark.parametrize("alpha", [0.4, 3.0])
def test_standard_gamma_moments(alpha):
    """20,000 draws: mean and variance alpha, each within 5 standard
    errors (the variance's from the gamma's fourth central moment)."""
    n = 20000
    tpaddle.seed(3)
    x = _np(tpaddle.standard_gamma(tpaddle.full([n], alpha)))
    assert abs(x.mean() - alpha) < 5 * np.sqrt(alpha / n)
    var_se = np.sqrt((3 * alpha ** 2 + 6 * alpha - alpha ** 2) / n)
    assert abs(x.var() - alpha) < 5 * var_se


TOL_DRAWS = {
    "normal_": lambda p: p.zeros([32]).normal_(0.5, 2.0),
    "log_normal_": lambda p: p.zeros([32]).log_normal_(),
    "standard_normal": lambda p: p.standard_normal([4, 8]),
    "log_normal": lambda p: p.log_normal(0.2, 0.5, [16]),
    "exponential_": lambda p: p.zeros([64]).exponential_(2.0),
    "cauchy_": lambda p: p.zeros([64]).cauchy_(1.0, 0.5),
}


@pytest.mark.parametrize("name", sorted(TOL_DRAWS))
def test_draws_within_float_tolerance(name):
    want, got = _both(TOL_DRAWS[name], 5)
    _close(want, got)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64"])
def test_finfo_fields(dtype):
    j, t = jpaddle.finfo(dtype), tpaddle.finfo(dtype)
    for f in ("min", "max", "eps", "tiny", "smallest_normal", "resolution",
              "bits"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype.rsplit(".", 1)[-1] == j.dtype.rsplit(".", 1)[-1]


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "uint8"])
def test_iinfo_fields(dtype):
    j, t = jpaddle.iinfo(dtype), tpaddle.iinfo(dtype)
    assert (t.min, t.max, t.bits) == (j.min, j.max, j.bits)


def test_set_printoptions_round_trip():
    before = np.get_printoptions()
    try:
        tpaddle.set_printoptions(precision=3, threshold=50, edgeitems=2,
                                 sci_mode=False, linewidth=60)
        set_by_port = np.get_printoptions()
        np.set_printoptions(**before)
        jpaddle.set_printoptions(precision=3, threshold=50, edgeitems=2,
                                 sci_mode=False, linewidth=60)
        assert set_by_port == np.get_printoptions()
        assert (set_by_port["precision"], set_by_port["suppress"]) == (3, True)
    finally:
        np.set_printoptions(**before)
    assert np.get_printoptions() == before


def test_inplace_table_is_jax_table():
    assert sorted(text._INPLACE) == sorted(jext._INPLACE)


RNG = np.random.default_rng(7)
F = RNG.uniform(0.2, 0.8, (2, 3)).astype(np.float32)
G = RNG.uniform(0.2, 0.8, (2, 3)).astype(np.float32)
I = RNG.integers(1, 9, (2, 3))
J = RNG.integers(1, 4, (2, 3))
B = RNG.integers(0, 2, (2, 3)).astype(bool)
C = RNG.integers(0, 2, (2, 3)).astype(bool)

# (input, args builder) by in-place form; the rest take F alone, and the
# binary forms F and G
_INT_BINARY = ("bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm",
               "bitwise_left_shift", "bitwise_right_shift")
_BOOL_BINARY = ("logical_and", "logical_or", "logical_xor")
_BINARY = ("pow", "divide", "floor_divide", "remainder", "mod", "floor_mod",
           "hypot", "copysign", "heaviside", "gammainc", "gammaincc",
           "ldexp", "equal", "not_equal", "greater_equal", "greater_than",
           "less_equal", "less_than")
INPLACE_ARGS = {
    "acosh_": (F + 1, lambda p: []),
    "multigammaln_": (F + 1, lambda p: [2]),
    "polygamma_": (F, lambda p: [1]),
    "renorm_": (F, lambda p: [2.0, 0, 0.5]),
    "bitwise_not_": (I, lambda p: []),
    "logical_not_": (B, lambda p: []),
    "masked_fill_": (F, lambda p: [p.to_tensor(B), 0.5]),
    "masked_scatter_": (F, lambda p: [p.to_tensor(B), p.to_tensor(G * 9)]),
    "cumsum_": (F, lambda p: [1]),
    "cumprod_": (F, lambda p: [1]),
    "flatten_": (F, lambda p: []),
    "cast_": (F, lambda p: ["float64"]),
    "t_": (F, lambda p: []),
    "transpose_": (F, lambda p: [[1, 0]]),
    "scatter_": (F, lambda p: [p.to_tensor(np.array([1, 0])),
                               p.to_tensor(G)]),
    "index_add_": (F, lambda p: [p.to_tensor(np.array([0, 2])), 1,
                                 p.to_tensor(G[:, :2])]),
    "index_fill_": (F, lambda p: [p.to_tensor(np.array([1])), 1, 0.5]),
    "index_put_": (F, lambda p: [(p.to_tensor(np.array([0, 1])),
                                  p.to_tensor(np.array([2, 0]))),
                                 p.to_tensor(_f([9.0, 8.0]))]),
    "lerp_": (F, lambda p: [p.to_tensor(G), 0.3]),
    "put_along_axis_": (F, lambda p: [p.to_tensor(np.array([[0], [1]])),
                                      5.0, 1]),
    **{n + "_": (I, lambda p: [p.to_tensor(J)]) for n in _INT_BINARY},
    **{n + "_": (B, lambda p: [p.to_tensor(C)]) for n in _BOOL_BINARY},
    **{n + "_": (F, lambda p: [p.to_tensor(G)]) for n in _BINARY},
}


@pytest.mark.parametrize("name", sorted(text._INPLACE))
def test_inplace_forms(name):
    a, args = INPLACE_ARGS.get(name, (F, lambda p: []))

    def run(p):
        x = _t(p, a)
        before = x.reshape([-1])
        out = getattr(x, name)(*args(p))
        assert out is x
        return [x, before]

    want, got = _both(run)
    for w, g in zip(want, got):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=name,
                                       **TOL[str(w.dtype)])
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[1], a.reshape(-1))
