"""Shared helpers of the eager-core parity tests (`test_torch_tensor.py`,
`test_torch_autograd.py`, `test_torch_random.py`,
`test_torch_eager_kernels.py`): the two packages, the port placed on the
CPU, and the comparison of one scenario's results across packages.

A scenario is a function of the package (`paddle`) returning a dict of
results. Every float array must agree within the tolerance of its dtype
(`TOL`), and everything else — integer and bool arrays, dtypes, shapes,
`stop_gradient` flags, strings — exactly.
"""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle

PACKAGES = {"jax": jpaddle, "torch": tpaddle}

# float tolerances by dtype: one f32 op may differ by a few ulps between
# XLA's CPU kernels and torch's (exp, log, sin, tanh, erfinv), and sums
# accumulate in different orders; f64 the same at its own precision
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "float64": dict(rtol=1e-10, atol=1e-12),
       "float16": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    """The port's tensors are created on the CPU (its default place is
    the card)."""
    from paddle_tpu_torch.framework import place

    with place.device_scope("cpu"):
        yield


def fresh(a):
    """A numpy copy of `a` for one package (the packages must not share
    a buffer)."""
    return np.array(a, copy=True)


def to_np(x):
    """A Tensor (of either package) as numpy; other values as they are."""
    if hasattr(x, "numpy") and hasattr(x, "stop_gradient"):
        return np.asarray(x.numpy())
    return x


def assert_same(want, got, path="out"):
    """`got` (the port's) against `want` (the JAX package's)."""
    want, got = to_np(want), to_np(got)
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        w, g = np.asarray(want), np.asarray(got)
        assert w.dtype.name == g.dtype.name, (path, w.dtype, g.dtype)
        assert w.shape == g.shape, (path, w.shape, g.shape)
        if w.dtype.name in TOL:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64),
                                       err_msg=path, **TOL[w.dtype.name])
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, err_msg=path,
                                   **TOL["float32"])
    else:
        assert got == want, (path, want, got)


class Scenarios:
    """Runs each scenario on both packages: the JAX package's results are
    kept per scenario, the port's held to them."""

    def __init__(self):
        self.jax = {}

    def run(self, scenario, pkg):
        if pkg == "jax":
            self.jax[scenario.__name__] = scenario(jpaddle)
            return
        got = scenario(tpaddle)
        if scenario.__name__ not in self.jax:
            self.jax[scenario.__name__] = scenario(jpaddle)
        assert_same(self.jax[scenario.__name__], got, scenario.__name__)
