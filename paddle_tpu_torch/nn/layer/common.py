"""Common layers: the port of `paddle_tpu/nn/layer/common.py` as far as
`Linear`, `LinearNoBias`, `Embedding`, `Dropout`, `Flatten` and
`Identity` (the padding, upsampling, bilinear, fold and shuffle layers
are not ported yet)."""
from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import XavierUniform
from .layers import Layer

__all__ = ["Linear", "LinearNoBias", "Embedding", "Dropout", "Flatten",
           "Identity"]


class Linear(Layer):
    """`y = x @ weight + bias` with weight `[in_features, out_features]`."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class LinearNoBias(Linear):
    def __init__(self, in_features, out_features, weight_attr=None,
                 name=None):
        super().__init__(in_features, out_features, weight_attr,
                         bias_attr=False)


class Embedding(Layer):
    """A `[num_embeddings, embedding_dim]` table; the `padding_idx` row is
    zero at construction and its lookups give zeros (no gradient). The
    `sparse` (SelectedRows) gradient is not ported yet."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        if sparse:
            raise NotImplementedError("Embedding(sparse=True): SelectedRows "
                                      "gradients are not ported yet")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierUniform())
        if padding_idx is not None:
            pi = padding_idx if padding_idx >= 0 \
                else num_embeddings + padding_idx
            with torch.no_grad():
                self.weight._data[pi] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ...ops import manipulation

        return manipulation.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
