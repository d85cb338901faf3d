"""Weight initializers: the port of `paddle_tpu/nn/initializer/__init__.py`.

Each initializer is a callable `(shape, dtype) -> torch.Tensor` on the
expected place. It draws on the host from
`np.random.default_rng((seed, counter))` after advancing the shared
generator (`framework/random.py`, `next_key`), in float64 as the JAX
package draws, rounds to the dtype, then moves the result to the device.
So `paddle.seed(s)` followed by building a layer gives the JAX package's
weights bit for bit. `Orthogonal` and `Dirac` are not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import dtype as dtype_mod
from ...framework import random as random_mod
from ...framework.place import expected_device

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "calculate_gain"]


def _np_rng():
    seed, counter = random_mod.default_generator().get_state()
    random_mod.default_generator().next_key()  # advance the shared state
    return np.random.default_rng((seed, counter))


def _finalize(arr, dtype) -> torch.Tensor:
    """The host array in `dtype` on the expected place; float64 narrows
    through torch, which rounds as the JAX package's conversion does."""
    from ...core.tensor import _to_torch

    t = _to_torch(np.asarray(arr), "cpu").to(dtype_mod.to_torch(dtype))
    return t.to(expected_device())


def _shape(shape):
    return tuple(int(s) for s in shape)


def calculate_gain(nonlinearity: str, param=None) -> float:
    recipes = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
               "conv3d": 1.0, "conv1d_transpose": 1.0,
               "conv2d_transpose": 1.0, "conv3d_transpose": 1.0,
               "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
               "leaky_relu": math.sqrt(2.0 / (1 + (
                   param if param is not None else 0.01) ** 2)),
               "selu": 3.0 / 4}
    if nonlinearity not in recipes:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return recipes[nonlinearity]


def _fans(shape):
    shape = _shape(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv weight [out_c, in_c, *kernel]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return _finalize(np.full(_shape(shape), self.value), dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _finalize(_np_rng().normal(self.mean, self.std, _shape(shape)),
                         dtype)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        r = _np_rng()
        x = r.normal(self.mean, self.std, _shape(shape))
        lo, hi = self.mean + self.a * self.std, self.mean + self.b * self.std
        bad = (x < lo) | (x > hi)
        while bad.any():
            x[bad] = r.normal(self.mean, self.std, int(bad.sum()))
            bad = (x < lo) | (x > hi)
        return _finalize(x, dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _finalize(_np_rng().uniform(self.low, self.high,
                                           _shape(shape)), dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype):
        from ...core.tensor import Tensor

        v = self.value
        if isinstance(v, Tensor):
            v = v.numpy()
        return _finalize(np.asarray(v).reshape(_shape(shape)), dtype)
