"""The port's layers (`paddle_tpu/nn/layer`): `Layer`, the containers,
and the common, activation, loss, norm, conv, pooling, recurrent,
transformer and extended layers."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import *  # noqa: F401,F403
from .extended import *  # noqa: F401,F403
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
