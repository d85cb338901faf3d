"""QAT and PTQ: the port of `paddle_tpu/quantization/__init__.py`
(reference `python/paddle/quantization/`: `QuantConfig`, `QAT`, `PTQ`,
the observers and quanters).

QAT swaps each quantable Layer (`Linear`, `Conv2D`, or the types a
`QuantConfig` names) for a fake-quant form whose weight and activation
pass `quant_dequant`; PTQ wraps them in observers, calibrates on data,
and converts either to the simulation form (weights quant-dequanted in
place) or, with `deploy_backend`, to `nn.quant.WeightOnlyLinear`: real
int8 / int4 / fp8 storage run by the weight-only gemm kernels.

As in the JAX package, `quant_dequant` of an eager Tensor returns a new
Tensor that stops gradient (its straight-through form,
`x + (q - x).detach()`, holds for torch tensors): a `QuantedLinear` /
`QuantedConv2D` in eager mode trains its bias only. The observers read
their inputs on the host (one read a call), as the JAX package's do.
"""
from __future__ import annotations

import copy
from typing import List, Type

import numpy as np
import torch

from ..core.tensor import Tensor
from ..nn.layer.layers import Layer

__all__ = ["QuantConfig", "QAT", "PTQ", "quanters", "observers",
           "AbsmaxObserver", "HistObserver", "ChannelAbsmaxObserver",
           "FakeQuanterWithAbsMax", "QuantedLinear", "QuantedConv2D",
           "quant_dequant"]


def _arr(x) -> torch.Tensor:
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _host_f32(x) -> np.ndarray:
    return _arr(x).detach().float().cpu().numpy()


def quant_dequant(x, scale, bits: int = 8):
    """Symmetric fake-quant: `round(x / scale * qmax)` clipped to
    [-qmax, qmax], times `scale / qmax`, with the identity gradient
    through the rounding (straight-through)."""
    qmax = float(2 ** (bits - 1) - 1)
    a = _arr(x)
    s = torch.clamp(torch.as_tensor(_arr(scale), dtype=torch.float32,
                                    device=a.device), min=1e-9)
    q = torch.clamp(torch.round(a / s * qmax), -qmax, qmax)
    out = q * s / qmax
    out = a + (out - a).detach()
    return Tensor(out) if isinstance(x, Tensor) else out


# -- observers (PTQ calibration) ----------------------------------------------

class BaseObserver:
    def __init__(self, quant_bits: int = 8):
        self.quant_bits = quant_bits
        self._scale = None

    def observe(self, x):
        raise NotImplementedError

    def scale(self) -> float:
        if self._scale is None:
            raise RuntimeError("observer saw no data")
        return float(self._scale)

    def qmax(self) -> float:
        return float(2 ** (self.quant_bits - 1) - 1)


class AbsmaxObserver(BaseObserver):
    """Running abs-max."""

    def observe(self, x):
        m = float(np.abs(_host_f32(x)).max())
        self._scale = m if self._scale is None else max(self._scale, m)


class ChannelAbsmaxObserver(BaseObserver):
    """Per-output-channel running abs-max over the last axis (one channel
    = one row of a `[..., N, K]` weight); `scales()` is `absmax / qmax`,
    the storage scale of `nn.quant`."""

    def observe(self, x):
        a = np.abs(_host_f32(x)).max(axis=-1)
        self._scale = a if self._scale is None \
            else np.maximum(self._scale, a)

    def scale(self) -> float:
        """The max over channels."""
        if self._scale is None:
            raise RuntimeError("observer saw no data")
        return float(np.max(self._scale))

    def absmax(self) -> np.ndarray:
        if self._scale is None:
            raise RuntimeError("observer saw no data")
        return np.asarray(self._scale, np.float32)

    def scales(self) -> np.ndarray:
        return (self.absmax() / self.qmax()).astype(np.float32)


class HistObserver(BaseObserver):
    """The scale at the `percent` point of the histogram of |x| (the
    accumulated mass re-binned when a wider batch arrives)."""

    def __init__(self, quant_bits: int = 8, percent: float = 0.999,
                 bins: int = 2048):
        super().__init__(quant_bits)
        self.percent = percent
        self.bins = bins
        self._hist = None
        self._edges = None

    def observe(self, x):
        a = np.abs(_host_f32(x)).ravel()
        hi = float(a.max()) if a.size else 1.0
        if self._hist is None:
            self._edges = np.linspace(0, max(hi, 1e-9), self.bins + 1)
            self._hist = np.zeros(self.bins)
        if hi > self._edges[-1]:
            new_edges = np.linspace(0, hi, self.bins + 1)
            centers = (self._edges[:-1] + self._edges[1:]) / 2
            idx = np.clip(np.searchsorted(new_edges, centers) - 1,
                          0, self.bins - 1)
            new_hist = np.zeros(self.bins)
            np.add.at(new_hist, idx, self._hist)
            self._hist, self._edges = new_hist, new_edges
        self._hist += np.histogram(a, bins=self._edges)[0]
        cdf = np.cumsum(self._hist)
        if cdf[-1] > 0:
            cut = np.searchsorted(cdf, self.percent * cdf[-1])
            self._scale = float(self._edges[min(cut + 1, self.bins)])


# -- quanters (QAT fake-quant layers) -----------------------------------------

class FakeQuanterWithAbsMax(Layer):
    """Fake-quant with an abs-max scale, a moving average of it while
    training."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9):
        super().__init__()
        self.quant_bits = quant_bits
        self.moving_rate = moving_rate
        self._scale_val = None

    def forward(self, x):
        m = float(np.abs(_host_f32(x)).max())
        if self._scale_val is None:
            self._scale_val = m
        elif self.training:
            r = self.moving_rate
            self._scale_val = r * self._scale_val + (1 - r) * m
        return quant_dequant(x, torch.tensor(self._scale_val,
                                             dtype=torch.float32),
                             self.quant_bits)

    def scale(self) -> float:
        return float(self._scale_val or 0.0)


class QuantedLinear(Layer):
    """`nn.Linear` with fake-quanted weight and activation."""

    def __init__(self, linear, q_config: "QuantConfig"):
        super().__init__()
        self.linear = linear
        self.weight_quanter = FakeQuanterWithAbsMax(q_config.weight_bits)
        self.activation_quanter = FakeQuanterWithAbsMax(
            q_config.activation_bits)

    def forward(self, x):
        from ..nn import functional as F

        xq = self.activation_quanter(x)
        wq = self.weight_quanter(self.linear.weight)
        return F.linear(xq, wq, self.linear.bias)


class QuantedConv2D(Layer):
    """`nn.Conv2D` with fake-quanted weight and activation."""

    def __init__(self, conv, q_config: "QuantConfig"):
        super().__init__()
        self.conv = conv
        self.weight_quanter = FakeQuanterWithAbsMax(q_config.weight_bits)
        self.activation_quanter = FakeQuanterWithAbsMax(
            q_config.activation_bits)

    def forward(self, x):
        from ..nn import functional as F

        xq = self.activation_quanter(x)
        wq = self.weight_quanter(self.conv.weight)
        return F.conv2d(xq, wq, self.conv.bias, stride=self.conv._stride,
                        padding=self.conv._padding,
                        dilation=self.conv._dilation,
                        groups=self.conv._groups)


class quanters:
    FakeQuanterWithAbsMax = FakeQuanterWithAbsMax


class observers:
    AbsmaxObserver = AbsmaxObserver
    HistObserver = HistObserver
    ChannelAbsmaxObserver = ChannelAbsmaxObserver


# -- config and drivers -------------------------------------------------------

class QuantConfig:
    """Which layers quantize, and at how many bits."""

    def __init__(self, activation=None, weight=None, weight_bits: int = 8,
                 activation_bits: int = 8):
        self.activation = activation
        self.weight = weight
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self._types: List[type] = []

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        self._types.extend(types)

    def _quantable(self, layer) -> bool:
        from ..nn.layer.common import Linear
        from ..nn.layer.conv import Conv2D

        if self._types:
            return isinstance(layer, tuple(self._types))
        return isinstance(layer, (Linear, Conv2D))


def _swap_layers(model: Layer, make) -> int:
    """Replace quantable sublayers in place; returns how many."""
    n = 0
    for parent in model.sublayers(include_self=True):
        for name, child in list(parent._sub_layers.items()):
            repl = make(child)
            if repl is not None:
                parent._sub_layers[name] = repl
                n += 1
    return n


class QAT:
    """Quantization-aware training: `quantize` swaps in the fake-quant
    Layers."""

    def __init__(self, q_config: QuantConfig):
        self.q_config = q_config

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        from ..nn.layer.common import Linear
        from ..nn.layer.conv import Conv2D

        target = model if inplace else copy.deepcopy(model)

        def make(layer):
            if isinstance(layer, (QuantedLinear, QuantedConv2D)) or \
                    not self.q_config._quantable(layer):
                return None
            if isinstance(layer, Conv2D):
                return QuantedConv2D(layer, self.q_config)
            if isinstance(layer, Linear):
                return QuantedLinear(layer, self.q_config)
            return None

        if _swap_layers(target, make) == 0:
            raise ValueError("no quantable layers found")
        return target

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        """Freeze the fake-quant scales (the quanted Linears to eval)."""
        target = model if inplace else copy.deepcopy(model)
        for layer in target.sublayers(include_self=True):
            if isinstance(layer, QuantedLinear):
                layer.eval()
        return target


class _Observed(Layer):
    """A quantable Layer with an activation and a weight observer."""

    def __init__(self, inner, ptq: "PTQ"):
        super().__init__()
        self.inner = inner
        self.act_observer = ptq.observer_cls(ptq.q_config.activation_bits)
        self.w_observer = ptq.observer_cls(ptq.q_config.weight_bits)
        self.w_observer.observe(inner.weight)
        ptq._observed.append(self)

    def forward(self, x):
        self.act_observer.observe(x)
        return self.inner(x)


class PTQ:
    """Post-training quantization: `quantize` wraps, running data
    calibrates, `convert` applies."""

    def __init__(self, q_config: QuantConfig,
                 observer_cls: Type[BaseObserver] = AbsmaxObserver):
        self.q_config = q_config
        self.observer_cls = observer_cls
        self._observed: List[_Observed] = []

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        target = model if inplace else copy.deepcopy(model)
        n = _swap_layers(target, lambda layer: _Observed(layer, self)
                         if self.q_config._quantable(layer) else None)
        if n == 0:
            raise ValueError("no quantable layers found")
        return target

    def convert(self, model: Layer, inplace: bool = False,
                deploy_backend: str = None) -> Layer:
        """The simulation form by default (each observed weight
        quant-dequanted in place at its calibrated scale); with
        `deploy_backend="weight_only_int8" | "weight_only_int4" | "fp8"`
        each observed Linear becomes a `WeightOnlyLinear`."""
        from ..nn.layer.common import Linear
        from ..nn.quant import WeightOnlyLinear

        target = model if inplace else copy.deepcopy(model)
        bits_w = self.q_config.weight_bits
        for parent in target.sublayers(include_self=True):
            for name, child in list(parent._sub_layers.items()):
                if not isinstance(child, _Observed):
                    continue
                lin = child.inner
                if deploy_backend is not None and isinstance(lin, Linear):
                    parent._sub_layers[name] = WeightOnlyLinear.from_linear(
                        lin, algo=deploy_backend)
                    continue
                w_scale = child.w_observer.scale()
                with torch.no_grad():
                    lin.weight._data.copy_(quant_dequant(
                        lin.weight._data.detach(),
                        torch.tensor(w_scale, dtype=torch.float32), bits_w))
                parent._sub_layers[name] = lin
        return target
