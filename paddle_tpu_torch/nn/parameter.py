"""Parameter: a trainable Tensor — the port of `paddle_tpu/nn/parameter.py`.

A `Parameter` is a `Tensor` with `stop_gradient=False`, `persistable=True`
and a `trainable` switch, created through an initializer object. Its
`_data` is a leaf `torch.Tensor` that requires grad while it is
trainable, so torch autograd accumulates into its `.grad`.
"""
from __future__ import annotations

from typing import Optional

from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod

__all__ = ["Parameter", "ParamAttr", "create_parameter"]


class Parameter(Tensor):
    __slots__ = ("optimize_attr", "regularizer", "do_model_average",
                 "need_clip", "is_distributed")

    def __init__(self, data, trainable: bool = True,
                 name: Optional[str] = None):
        super().__init__(data, stop_gradient=not trainable, name=name)
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.do_model_average = None
        self.need_clip = True
        self.is_distributed = False

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v: bool):
        self.stop_gradient = not v

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

    __str__ = __repr__

    def __deepcopy__(self, memo):
        p = Parameter(self._data.detach().clone(), trainable=self.trainable,
                      name=self.name + "_copy")
        memo[id(self)] = p
        return p


def create_parameter(shape, dtype=None, name=None, attr=None,
                     is_bias: bool = False,
                     default_initializer=None) -> Parameter:
    """`paddle.create_parameter`: the initializer's draw (the attr's, else
    `default_initializer`, else zeros for a bias and XavierUniform for a
    weight) on the expected place."""
    from . import initializer as I

    dtype = dtype_mod.convert_dtype(dtype or dtype_mod.get_default_dtype())
    attr = ParamAttr._to_attr(attr)
    init = default_initializer
    if attr is not None and attr.initializer is not None:
        init = attr.initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    data = init(shape, dtype)
    trainable = attr.trainable if attr is not None else True
    p = Parameter(data, trainable=trainable,
                  name=(attr.name if attr is not None and attr.name
                        else name))
    if attr is not None:
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
    return p


class ParamAttr:
    """Parameter attribute bundle (`python/paddle/base/param_attr.py`)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        from . import initializer as I

        if attr is None:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return ParamAttr(trainable=False)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")
