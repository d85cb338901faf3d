"""`paddle.nn` of the port: `Layer` and every layer of the JAX package
(`nn/layer`), the parameter and initializer surface, `nn.functional`,
gradient clipping (`nn/clip.py`), and weight-only quantization
(`nn/quant.py`)."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (activation as _activation, common as _common,
                    container as _container, conv as _conv,
                    extended as _extended, loss as _loss, norm as _norm,
                    pooling as _pooling, rnn as _rnn,
                    transformer as _transformer)
from .layer import *  # noqa: F401,F403
from .layer.layers import Layer
from .parameter import Parameter, ParamAttr, create_parameter

__all__ = ["functional", "initializer", "Layer", "Parameter", "ParamAttr",
           "create_parameter", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "LayerDict", "LayerList", "ParameterList",
           "Sequential"] \
    + sum((m.__all__ for m in (_activation, _common, _conv, _extended,
                               _loss, _norm, _pooling, _rnn,
                               _transformer)), [])
