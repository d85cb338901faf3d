"""The edges where torch and JAX differ, on both packages: stable sorts,
`topk`'s ties, the even-count median, unbiased `std` / `var`,
interpolating `quantile`, rounding half away from zero, the divisor's
sign in `mod`, `cumsum`'s dtypes, `nan_to_num`'s extremes, `logsumexp` of
`-inf`, `unique`'s order and outputs, a logical right shift, the seeded
draws' bits; the index raise (a closed divergence: JAX clamps a gather
and drops a scatter); the in-place forms and the Tensor-method binding;
and the op names the port registers against the JAX package's."""
import os
import re

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_eager_common import assert_same, fresh, port_on_cpu  # noqa: F401
from torch_ops_surface_common import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(fn):
    assert_same(fn(jpaddle), fn(tpaddle), fn.__name__)


def test_sort_argsort_topk_ties():
    x = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0]])

    def ties(p):
        t = p.to_tensor(fresh(x))
        out = {"sort": p.sort(t), "sort_desc": p.sort(t, descending=True),
               "argsort": p.argsort(t),
               "argsort_desc": p.argsort(t, descending=True)}
        for k in (1, 2, 4):
            v, i = p.topk(t, k)
            sv, si = p.topk(t, k, largest=False)
            out[f"top{k}"] = (v, i, sv, si)
        return out

    _both(ties)


def test_median_std_var_quantile():
    x = np.array([[4.0, 1.0, 3.0, 2.0], [0.5, 9.0, 7.0, 8.0]])
    y = np.array([1.0, np.nan, 3.0, 2.0])

    def stats(p):
        t = p.to_tensor(fresh(x))
        return {"median": p.median(t), "median0": p.median(t, axis=0),
                "median1k": p.median(t, axis=1, keepdim=True),
                "nanmedian": p.nanmedian(p.to_tensor(fresh(y))),
                "median_nan": p.median(p.to_tensor(fresh(y))),
                "std": p.std(t), "std_b": p.std(t, axis=1, unbiased=False),
                "var": p.var(t, axis=0), "var_b": p.var(t, unbiased=False),
                "q": p.quantile(t, 0.3), "qs": p.quantile(t, [0.1, 0.75],
                                                         axis=1),
                "q_int_median": p.median(p.to_tensor([3, 1, 2, 4]))}

    _both(stats)


def test_round_mod_cumsum_nan_to_num_logsumexp():
    def edges(p):
        h = p.to_tensor(np.array([-2.5, -0.5, 0.5, 1.5, 2.5, 0.25]))
        a = p.to_tensor(np.array([-7, 7, -7, 7]))
        b = p.to_tensor(np.array([3, -3, -3, 3]))
        f = p.to_tensor(np.array([-7.5, 7.5, -7.5, 7.5]))
        inf = np.array([np.nan, np.inf, -np.inf, 1.0])
        return {"round": p.round(h), "round1": p.round(h, decimals=1),
                "mod": p.mod(a, b), "floor_mod": p.floor_mod(f, b.astype(
                    "float64")), "remainder": p.remainder(f, 2.0),
                "cumsum32": p.cumsum(p.to_tensor(np.arange(6, dtype=np.int32)
                                                 .reshape(2, 3)), axis=1),
                "cumsum_bool": p.cumsum(p.to_tensor(np.array(
                    [True, False, True]))),
                "cumprod": p.cumprod(p.to_tensor(np.array([[1, 2], [3, 4]])),
                                     dim=1),
                "nan_to_num32": p.nan_to_num(p.to_tensor(fresh(inf).astype(
                    np.float32))),
                "nan_to_num64": p.nan_to_num(p.to_tensor(fresh(inf)),
                                             nan=1.5, neginf=-2.0),
                "lse": p.logsumexp(p.to_tensor(np.array(
                    [[-np.inf, -np.inf], [0.0, 1.0]])), axis=1),
                "lse_all": p.logsumexp(p.to_tensor(np.array([1.0, 2.0])))}

    _both(edges)


def test_unique_nonzero_masked_select():
    x = np.array([3, 1, 2, 3, 1, 5, 1])
    c = np.array([1, 1, 2, 2, 3, 1, 1, 2])

    def dyn(p):
        t = p.to_tensor(fresh(x))
        return {"unique": p.unique(t),
                "unique_all": p.unique(t, return_index=True,
                                       return_inverse=True,
                                       return_counts=True),
                "consecutive": p.unique_consecutive(
                    p.to_tensor(fresh(c)), return_inverse=True,
                    return_counts=True),
                "nonzero": p.nonzero(t > 1),
                "nonzero_tuple": p.nonzero(t > 1, as_tuple=True),
                "masked_select": p.masked_select(t, t > 2)}

    _both(dyn)


def test_logical_right_shift_and_bitwise():
    def shifts(p):
        x = p.to_tensor(np.array([-16, -1, 16, 7], dtype=np.int32))
        s = p.to_tensor(np.array([1, 4, 2, 0], dtype=np.int32))
        return {"arith": p.bitwise_right_shift(x, s),
                "logic": p.bitwise_right_shift(x, s, is_arithmetic=False),
                "left": p.bitwise_left_shift(x, s)}

    _both(shifts)


@pytest.mark.parametrize("n", [1, 7, 100, 2000])
def test_randperm_bits(n):
    def perm(p):
        p.seed(123)
        return {"perm": p.randperm(n), "perm32": p.randperm(n, "int32")}

    _both(perm)


def test_seeded_draws_bits():
    probs = np.random.default_rng(5).uniform(0.1, 0.9, (4, 7))

    def draws(p):
        p.seed(9)
        pr = p.to_tensor(fresh(probs))
        return {"bern": p.bernoulli(pr),
                "mn": p.multinomial(pr[0], 3),
                "mn_rep": p.multinomial(pr[0], 5, replacement=True),
                "mn2": p.multinomial(pr, 4),
                "mn2_rep": p.multinomial(pr, 6, replacement=True),
                "rrelu": p.nn.functional.rrelu(pr - 0.5, training=True)}

    _both(draws)


def test_out_of_range_indices_raise_where_jax_clamps():
    """A closed divergence: the JAX package runs an out-of-range gather
    (clamped, or filled with NaN by `jnp.take`) and drops an out-of-range
    scatter; the port raises (on the card the kernel asserts)."""
    x = np.arange(12.0).reshape(3, 4)
    bad = np.array([0, 5])
    j = jpaddle.to_tensor(fresh(x))
    jpaddle.index_select(j, jpaddle.to_tensor(bad)).numpy()
    jpaddle.scatter(j, jpaddle.to_tensor(bad), jpaddle.to_tensor(
        np.ones((2, 4))))
    t = tpaddle.to_tensor(fresh(x))
    idx = tpaddle.to_tensor(bad)
    calls = [
        lambda: tpaddle.index_select(t, idx),
        lambda: tpaddle.gather(t, idx),
        lambda: tpaddle.take_along_axis(t, tpaddle.to_tensor(
            np.array([[0], [9], [1]])), 1),
        lambda: tpaddle.gather_nd(t, tpaddle.to_tensor(np.array([[7, 0]]))),
        lambda: tpaddle.scatter(t, idx, tpaddle.to_tensor(np.ones((2, 4)))),
        lambda: tpaddle.scatter_nd_add(t, tpaddle.to_tensor(
            np.array([[3]])), tpaddle.to_tensor(np.ones((1, 4)))),
        lambda: tpaddle.put_along_axis(t, tpaddle.to_tensor(
            np.array([[9], [0], [0]])), 1.0, 1),
    ]
    for call in calls:
        with pytest.raises((IndexError, RuntimeError)):
            call()


def test_inplace_forms_rebind_and_refuse_grad_leaves():
    def inplace(p):
        x = p.to_tensor(np.array([-1.5, 2.25, -3.0]))
        y = x.abs_()
        z = p.to_tensor(np.array([1.0, 4.0, 9.0]))
        p.sqrt_(z)
        m = p.to_tensor(np.array([7, -7]))
        m.mod_(p.to_tensor(np.array([3, 3])))
        c = p.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]]))
        c.tril_()
        return {"abs_": x, "same": y is x, "sqrt_": z, "mod_": m,
                "tril_": c}

    _both(inplace)
    for pkg in (jpaddle, tpaddle):
        w = pkg.to_tensor(np.ones(3), stop_gradient=False)
        with pytest.raises(RuntimeError, match="[Ll]eaf"):
            w.exp_()


def test_tensor_methods_bound_as_the_reference_binds_them():
    """Every reference method name whose function is ported is a method
    of the port's Tensor, calling the same-named function; the others
    stay unbound (`AttributeError`), never stubbed. With the extended ops,
    linalg, fft and signal ported, all 380 are bound."""
    from paddle_tpu_torch.tensor_method_names import TENSOR_METHOD_NAMES

    assert TENSOR_METHOD_NAMES == __import__(
        "paddle_tpu.tensor_method_names",
        fromlist=["TENSOR_METHOD_NAMES"]).TENSOR_METHOD_NAMES
    t = tpaddle.to_tensor(np.array([[1.0, -2.0], [3.0, 4.0]]))
    bound = [n for n in TENSOR_METHOD_NAMES if hasattr(tpaddle.Tensor, n)]
    assert len(bound) == len(TENSOR_METHOD_NAMES) == 380
    for n in TENSOR_METHOD_NAMES:
        fn = getattr(tpaddle, n, None)
        if callable(fn) and not isinstance(fn, type):
            assert hasattr(tpaddle.Tensor, n), n
        elif not hasattr(tpaddle.Tensor, n):
            with pytest.raises(AttributeError):
                getattr(t, n)
    np.testing.assert_allclose(t.logsumexp().numpy(),
                               np.log(np.exp(t.numpy()).sum()))
    np.testing.assert_array_equal(t.argmin(axis=1).numpy(), [1, 0])
    np.testing.assert_allclose(t.trace().numpy(), np.trace(t.numpy()))


_OP_CALL = re.compile(r'(?:register_op|_reg|make_unary|make_float_unary|'
                      r'make_binary|make_compare|_rand_op)\(\s*"(\w+)"')
_MODULES = ["ops/math.py", "ops/reduction.py", "ops/comparison.py",
            "ops/creation.py", "ops/manipulation.py", "ops/activation.py",
            "nn/functional/loss.py", "nn/functional/attention.py"]
# JAX op names the port has no op for, and why
JAX_ONLY = {
    "full": "creation ops make their tensor on the place, not through "
            "dispatch (the port's eager core)",
    "arange": "as full", "eye": "as full", "linspace": "as full",
    "uniform_random": "as full (the draws' bits are JAX's)",
    "gaussian_random": "as uniform_random", "randint": "as uniform_random",
    "cummax": "registered by JAX's math.py for ops/extended.py's cummax, "
              "which waits for slice 3b",
    "cummin": "as cummax",
}
# port op names whose JAX op carries a count in its name (concat_<n>,
# split_<n>, stack_<n>, unbind_<n>_<axis>) or which the JAX module
# registers under a name held in a variable
PORT_ONLY = {"concat", "split", "stack", "unbind", "getitem", "setitem",
             "pad", "select_scatter", "pow_scalar", "multinomial_rep",
             "multinomial_norep"}


def _names(pkg_dir):
    out = set()
    for m in _MODULES:
        path = os.path.join(REPO, pkg_dir, m)
        out |= set(_OP_CALL.findall(open(path).read()))
    return out


def test_registered_op_names_match_jax():
    """The op names the port's modules of this surface register are the
    JAX package's, so the AMP lists and the lazy recorder key on the same
    names; the differences are listed with their reasons."""
    from paddle_tpu.core import dispatch as jdispatch
    from paddle_tpu_torch.core import dispatch as tdispatch

    jax_names, port_names = _names("paddle_tpu"), _names("paddle_tpu_torch")
    assert jax_names - port_names == set(JAX_ONLY)
    assert port_names - jax_names <= PORT_ONLY
    for n in port_names:
        assert n in tdispatch.op_registry(), n
    for n in PORT_ONLY & set(jdispatch.op_registry()):
        assert n in tdispatch.op_registry()
