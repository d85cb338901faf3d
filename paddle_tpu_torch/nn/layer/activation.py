"""Activation layers: the port of `paddle_tpu/nn/layer/activation.py`
(the reference's `python/paddle/nn/layer/activation.py`), one Layer per
activation of `nn.functional`; `PReLU` holds its slopes as a parameter,
`RReLU` draws its slopes in training."""
from __future__ import annotations

from ...ops import activation as _act
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "ReLU", "ReLU6", "RReLU", "SELU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink", "Softsign",
           "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]


def _simple(name, fn, **default_kw):
    class _Act(Layer):
        def __init__(self, name=None, **kw):
            super().__init__()
            merged = dict(default_kw)
            merged.update(kw)
            self._kw = merged

        def forward(self, x):
            return fn(x, **self._kw)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


Hardsigmoid = _simple("Hardsigmoid", _act.hardsigmoid)
Hardswish = _simple("Hardswish", _act.hardswish)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


LogSigmoid = _simple("LogSigmoid", _act.log_sigmoid)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class Mish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.mish(x)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


ReLU = _simple("ReLU", _act.relu)
ReLU6 = _simple("ReLU6", _act.relu6)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


SELU = _simple("SELU", _act.selu)
Sigmoid = _simple("Sigmoid", _act.sigmoid)
Silu = _simple("Silu", _act.silu)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


Softsign = _simple("Softsign", _act.softsign)
Swish = _simple("Swish", _act.swish)

from ...ops import math as _math  # noqa: E402

Tanh = _simple("Tanh", lambda x: _math.tanh(x))
Tanhshrink = _simple("Tanhshrink", _act.tanhshrink)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)
