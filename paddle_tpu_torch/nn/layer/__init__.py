"""The port's layers (`paddle_tpu/nn/layer`): `Layer`, the containers,
the common, activation, loss and norm layers."""
from .activation import *  # noqa: F401,F403
from .common import Dropout, Embedding, Flatten, Identity, Linear, LinearNoBias
from .container import LayerDict, LayerList, ParameterList, Sequential
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import LayerNorm, RMSNorm
