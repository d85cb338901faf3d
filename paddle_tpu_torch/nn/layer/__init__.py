"""The port's layers (`paddle_tpu/nn/layer`): `Layer`, the containers,
the common, activation and norm layers."""
from .activation import (ELU, GELU, Hardswish, LeakyReLU, Mish, PReLU, ReLU,
                         Sigmoid, Silu, Softmax, Softplus, Swish, Tanh)
from .common import Dropout, Embedding, Flatten, Identity, Linear, LinearNoBias
from .container import LayerDict, LayerList, ParameterList, Sequential
from .layers import Layer
from .norm import LayerNorm, RMSNorm
