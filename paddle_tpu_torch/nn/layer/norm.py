"""Norm layers: the port of `paddle_tpu/nn/layer/norm.py`. `RMSNorm`
calls `nn.functional.rms_norm`, so it reaches the RMSNorm kernel
(`csrc/rms_norm.cu`) on CUDA tensors and its plain version on CPU
tensors; the others are the plain functionals of `functional/norm.py`.

The batch norms keep the JAX package's buffers `_mean` (zeros) and
`_variance` (ones) and its momentum convention (0.9 keeps 90 % of the
running value). The buffers stay float32: the JAX package's running
variance turns float64 after a training step (its unbiased factor is a
numpy float64 under `jax_enable_x64`); the port's values agree within
float32's tolerance. `SyncBatchNorm` is `BatchNorm`: the JAX package
reduces over the whole (sharded) batch array; a per-rank PyTorch process
group has no such array, and the port has no cross-rank reduction here.
`SpectralNorm`'s `weight_u` / `weight_v` are trainable parameters that
each forward overwrites (under `no_grad`) with its power iteration's
vectors, as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor
from ...framework.place import expected_device
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "RMSNorm", "SpectralNorm"]


def _affine(layer, shape, weight_attr, bias_attr):
    layer.weight = None if weight_attr is False else layer.create_parameter(
        shape, attr=weight_attr, default_initializer=Constant(1.0))
    layer.bias = None if bias_attr is False else layer.create_parameter(
        shape, attr=bias_attr, is_bias=True)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine(self, [num_features], weight_attr, bias_attr)
        dev = expected_device()
        self.register_buffer("_mean", Tensor(torch.zeros(
            num_features, dtype=torch.float32, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(
            num_features, dtype=torch.float32, device=dev)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, " \
            f"momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        data_format = {"NCL": "NCW", "NLC": "NWC"}.get(data_format,
                                                       data_format)
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """`BatchNorm` (see the module's note)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm in it replaced by a
        SyncBatchNorm sharing its parameters and buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format)
            if layer.weight is not None:
                out.weight = layer.weight
            if layer.bias is not None:
                out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in list(layer._sub_layers.items()):
            out.add_sublayer(name, cls.convert_sync_batchnorm(sub))
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                self._normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(self._normalized_shape,
                                              attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """RMSNorm over the last axis with a `[hidden_size]` weight (ones)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter([hidden_size], attr=weight_attr,
                                            default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        _affine(self, [num_channels], weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        _affine(self, [num_features], weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """`weight / sigma`, sigma from `power_iters` steps of the power
    iteration on the weight as a `[shape[dim], -1]` matrix."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim, self._power_iters, self._epsilon = dim, power_iters, \
            epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter([h])
        self.weight_v = self.create_parameter([w])

    def forward(self, weight):
        from ...core.autograd import no_grad
        from ...ops import linalg, manipulation
        from .layers import _rebind

        w = manipulation.moveaxis(weight, self._dim, 0)
        mat = manipulation.reshape(w, [w.shape[0], -1])
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = F.normalize(linalg.matmul(mat, u, transpose_x=True), axis=0,
                            epsilon=self._epsilon)
            u = F.normalize(linalg.matmul(mat, v), axis=0,
                            epsilon=self._epsilon)
        # new values for the parameters, as the JAX package's set_value
        # rebinds them: the graph above still reads the old ones
        with no_grad():
            _rebind(self.weight_u, u._data.detach().clone())
            _rebind(self.weight_v, v._data.detach().clone())
        sigma = linalg.dot(u, linalg.matmul(mat, v))
        return weight / sigma
