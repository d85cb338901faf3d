"""`paddle.nn` of the port: `Layer` and its core, activation and loss
layers (`nn/layer`), the parameter and initializer surface,
`nn.functional`, gradient clipping (`nn/clip.py`), and weight-only
quantization (`nn/quant.py`)."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import activation as _activation
from .layer import loss as _loss
from .layer import (Dropout, Embedding, Flatten, Identity, Layer, LayerDict,
                    LayerList, LayerNorm, Linear, LinearNoBias, ParameterList,
                    RMSNorm, Sequential)
from .layer.activation import *  # noqa: F401,F403
from .layer.loss import *  # noqa: F401,F403
from .parameter import Parameter, ParamAttr, create_parameter

__all__ = ["functional", "initializer", "Layer", "Sequential", "LayerList",
           "LayerDict", "ParameterList", "Linear", "LinearNoBias",
           "Embedding", "Dropout", "Flatten", "Identity", "LayerNorm",
           "RMSNorm", "Parameter", "ParamAttr", "create_parameter",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"] \
    + _activation.__all__ + _loss.__all__
