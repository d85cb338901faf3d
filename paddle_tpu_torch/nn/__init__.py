"""`paddle.nn` of the port: `Layer` and its core layers (`nn/layer`), the
parameter and initializer surface, `nn.functional`, and weight-only
quantization (`nn/quant.py`)."""
from . import functional, initializer
from .layer import (ELU, GELU, Dropout, Embedding, Flatten, Hardswish,
                    Identity, Layer, LayerDict, LayerList, LayerNorm,
                    LeakyReLU, Linear, LinearNoBias, Mish, ParameterList,
                    PReLU, ReLU, RMSNorm, Sequential, Sigmoid, Silu, Softmax,
                    Softplus, Swish, Tanh)
from .parameter import Parameter, ParamAttr, create_parameter

__all__ = ["functional", "initializer", "Layer", "Sequential", "LayerList",
           "LayerDict", "ParameterList", "Linear", "LinearNoBias",
           "Embedding", "Dropout", "Flatten", "Identity", "ELU", "GELU",
           "Hardswish", "LeakyReLU", "Mish", "PReLU", "ReLU", "Sigmoid",
           "Silu", "Softmax", "Softplus", "Swish", "Tanh", "LayerNorm",
           "RMSNorm", "Parameter", "ParamAttr", "create_parameter"]
