"""Shared helpers of the `nn` layer-surface parity tests
(`test_torch_nn_conv_pool.py`, `test_torch_nn_norm.py`,
`test_torch_rnn.py`, `test_torch_transformer.py`,
`test_torch_nn_extended.py`): a scenario is a function of the package
returning a dict of results, run on both packages from the same seeded
numpy inputs. Outputs are held to the JAX package's as
`torch_eager_common.assert_same` holds them (float32 within 1e-5
relative, integers, indices, shapes and seeded draws exactly); the
entries under a key `grads` are gradients, held within `GRAD_TOL`
norm-relative (a sum over many products, which XLA and torch order
differently). A key projection's bias gets no gradient in exact
arithmetic (softmax ignores a per-query shift): its rounding noise is
held within an absolute `ZERO_GRAD_ATOL` instead."""
import numpy as np
import pytest

from torch_eager_common import (assert_same, fresh, jpaddle,  # noqa: F401
                                port_on_cpu, to_np, tpaddle)

PKGS = ("jax", "torch")
GRAD_TOL = 1e-4
ZERO_GRAD_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's tensors: they are tiny, and six
    test workers' default thread pools (one thread a core each)
    oversubscribe the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def assert_grads(want, got, path):
    want, got = to_np(want), to_np(got)
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_grads(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_grads(w, g, f"{path}[{i}]")
    else:
        w, g = np.asarray(want), np.asarray(got)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), (path, w.dtype,
                                                          g.dtype)
        if path.endswith("k_proj.bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=ZERO_GRAD_ATOL,
                                       err_msg=path)
            return
        err = norm_rel(g, w)
        assert err <= GRAD_TOL, (path, err)


def assert_results(want, got, path):
    assert set(want) == set(got), (path, set(want) ^ set(got))
    for k in want:
        if k == "grads":
            assert_grads(want[k], got[k], f"{path}.{k}")
        else:
            assert_same(want[k], got[k], f"{path}.{k}")


class Scenarios:
    """Each scenario on both packages: the JAX package's results kept per
    scenario, the port's held to them."""

    def __init__(self):
        self.jax = {}

    def run(self, scenario, pkg):
        if pkg == "jax":
            self.jax[scenario.__name__] = scenario(jpaddle)
            return
        got = scenario(tpaddle)
        if scenario.__name__ not in self.jax:
            self.jax[scenario.__name__] = scenario(jpaddle)
        assert_results(self.jax[scenario.__name__], got, scenario.__name__)


def t(paddle, x, sg=True):
    """A fresh Tensor of the package from numpy data."""
    return paddle.to_tensor(fresh(np.asarray(x)), stop_gradient=sg)


def rng(seed=0):
    return np.random.default_rng(seed)


def grads_of(loss, tensors):
    """`loss.backward()`, then each tensor's gradient (dict name ->
    Tensor)."""
    loss.backward()
    return {n: x.grad for n, x in tensors.items()}


def cotangent_grads(paddle, outputs, tensors):
    """`paddle.autograd.backward(outputs, cotangents)` with a seeded
    standard-normal cotangent for each output, then each tensor's
    gradient (dict name -> Tensor). A random cotangent stands for a
    scalar loss built from the outputs, which would add ops (and their
    compiles, on the JAX package) for each output."""
    r = rng(99)
    cts = [t(paddle, r.standard_normal(tuple(o.shape)).astype("float32"))
           for o in outputs]
    paddle.autograd.backward(list(outputs), cts)
    return {n: x.grad for n, x in tensors.items()}


def param_grads(layer):
    return {n: p.grad for n, p in layer.named_parameters()
            if p.grad is not None}


def scenario_test(scenarios):
    """The parametrized test of a module's scenario list."""
    sc = Scenarios()

    @pytest.mark.parametrize("pkg", PKGS)
    @pytest.mark.parametrize("scenario", scenarios,
                             ids=lambda f: f.__name__)
    def test_scenario(scenario, pkg):
        sc.run(scenario, pkg)

    return test_scenario
