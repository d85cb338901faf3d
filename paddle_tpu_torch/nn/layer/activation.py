"""Activation layers: the port of `paddle_tpu/nn/layer/activation.py` for
the activations of `nn.functional` (`ReLU`, `GELU`, `Silu` / `Swish`,
`Sigmoid`, `Tanh`, `LeakyReLU`, `ELU`, `Hardswish`, `Mish`, `Softplus`),
`Softmax` and `PReLU`."""
from __future__ import annotations

from ...ops import activation as _act
from ...ops import math as _math
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["ELU", "GELU", "Hardswish", "LeakyReLU", "Mish", "PReLU", "ReLU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Swish", "Tanh"]


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


Hardswish = _simple("Hardswish", _act.hardswish)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


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
Sigmoid = _simple("Sigmoid", _act.sigmoid)
Silu = _simple("Silu", _act.silu)
Swish = _simple("Swish", _act.swish)


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


Tanh = _simple("Tanh", lambda x: _math.tanh(x))
