"""`paddle.nn.functional` of the port. `rms_norm` and
`scaled_dot_product_attention` are routed as the JAX package routes them
(`paddle_tpu/nn/functional/`): to the hand-written kernels on the shapes
those kernels take (their `supported()`) and to plain composites
otherwise; they take plain `torch.Tensor`s (the Llama model's and the
engines') as well as eager Tensors. `cross_entropy` (torch tensors) is
plain. `linear`, `embedding`, `dropout`, `layer_norm` and the
activations (re-exported from `ops.activation`, as in the JAX package)
take eager Tensors."""
from ...ops.activation import (elu, gelu, hardswish, leaky_relu, mish,
                               prelu, relu, sigmoid, silu, softmax, softplus,
                               swish)
from ...ops.math import tanh
from .attention import scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "rms_norm", "scaled_dot_product_attention",
           "layer_norm", "linear", "embedding", "dropout", "elu", "gelu",
           "hardswish", "leaky_relu", "mish", "prelu", "relu", "sigmoid",
           "silu", "softmax", "softplus", "swish", "tanh"]
