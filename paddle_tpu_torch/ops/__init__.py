"""Operators of the port: the eager ops over `Tensor` (creation, math,
manipulation, comparison, reduction, `matmul`, `softmax`), attached to
`Tensor` as methods and dunders here as the JAX package's
`ops/__init__.py` attaches them; the serving sampler (`ops.sampling`);
and the hand-written kernels (`ops.kernels`)."""
from __future__ import annotations

from ..core.tensor import Tensor
from . import (activation, comparison, creation, linalg, manipulation, math,
               reduction)
from .activation import softmax
from .comparison import (bitwise_and, bitwise_not, bitwise_or, bitwise_xor,
                         equal, equal_all, greater_equal, greater_than,
                         is_tensor, less_equal, less_than, logical_and,
                         logical_not, logical_or, not_equal)
from .creation import (arange, assign, clone, eye, full, linspace, normal,
                       ones, rand, randint, randn, to_tensor, uniform, zeros)
from .linalg import matmul
from .manipulation import (astype, cast, concat, gather, reshape, split,
                           squeeze, stack, transpose, where)
from .math import (abs, add, add_, clip, divide, exp, floor_divide, log,
                   maximum, minimum, multiply, neg, pow, remainder, round,
                   scale, sigmoid, sin, sqrt, subtract, tanh)
from .reduction import all, any, argmax, max, mean, min, sum

__all__ = ["softmax", "bitwise_and", "bitwise_not", "bitwise_or",
           "bitwise_xor", "equal", "equal_all", "greater_equal",
           "greater_than", "is_tensor", "less_equal", "less_than",
           "logical_and", "logical_not", "logical_or", "not_equal", "arange",
           "assign", "clone", "eye", "full", "linspace", "normal", "ones",
           "rand", "randint", "randn", "to_tensor", "uniform", "zeros",
           "matmul", "astype", "cast", "concat", "gather", "reshape",
           "split", "squeeze", "stack", "transpose", "where", "abs", "add",
           "add_", "clip", "divide", "exp", "floor_divide", "log",
           "maximum", "minimum", "multiply", "neg", "pow", "remainder",
           "round", "scale", "sigmoid", "sin", "sqrt", "subtract", "tanh",
           "all", "any", "argmax", "max", "mean", "min", "sum"]

_METHODS = dict(
    add=math.add, subtract=math.subtract, multiply=math.multiply,
    divide=math.divide, floor_divide=math.floor_divide,
    remainder=math.remainder, mod=math.remainder, pow=math.pow,
    maximum=math.maximum, minimum=math.minimum, clip=math.clip,
    exp=math.exp, log=math.log, sqrt=math.sqrt, sin=math.sin,
    tanh=math.tanh, sigmoid=math.sigmoid, abs=math.abs, neg=math.neg,
    round=math.round, scale=math.scale, add_=math.add_,
    sum=reduction.sum, mean=reduction.mean, max=reduction.max,
    min=reduction.min, all=reduction.all, any=reduction.any,
    argmax=reduction.argmax,
    equal=comparison.equal, not_equal=comparison.not_equal,
    greater_than=comparison.greater_than,
    greater_equal=comparison.greater_equal,
    less_than=comparison.less_than, less_equal=comparison.less_equal,
    logical_and=comparison.logical_and, logical_or=comparison.logical_or,
    logical_not=comparison.logical_not, equal_all=comparison.equal_all,
    matmul=linalg.matmul,
    reshape=manipulation.reshape, squeeze=manipulation.squeeze,
    transpose=manipulation.transpose,
    cast=manipulation.cast,
    astype=manipulation.cast, split=manipulation.split,
    gather=manipulation.gather, where=manipulation.where,
    softmax=activation.softmax,
)

for _name, _fn in _METHODS.items():
    setattr(Tensor, _name, _fn)


def _swap(fn):
    def swapped(self, other, name=None):
        return fn(other, self)

    return swapped


Tensor.__add__ = math.add
Tensor.__radd__ = math.add
Tensor.__sub__ = math.subtract
Tensor.__rsub__ = _swap(math.subtract)
Tensor.__mul__ = math.multiply
Tensor.__rmul__ = math.multiply
Tensor.__truediv__ = math.divide
Tensor.__rtruediv__ = _swap(math.divide)
Tensor.__floordiv__ = math.floor_divide
Tensor.__rfloordiv__ = _swap(math.floor_divide)
Tensor.__mod__ = math.remainder
Tensor.__rmod__ = _swap(math.remainder)
Tensor.__pow__ = math.pow
Tensor.__rpow__ = _swap(math.pow)
Tensor.__neg__ = lambda self: math.neg(self)
Tensor.__abs__ = lambda self: math.abs(self)
Tensor.__matmul__ = linalg.matmul
Tensor.__rmatmul__ = _swap(linalg.matmul)
Tensor.__eq__ = comparison.equal
Tensor.__ne__ = comparison.not_equal
Tensor.__lt__ = comparison.less_than
Tensor.__le__ = comparison.less_equal
Tensor.__gt__ = comparison.greater_than
Tensor.__ge__ = comparison.greater_equal
Tensor.__and__ = comparison.bitwise_and
Tensor.__or__ = comparison.bitwise_or
Tensor.__xor__ = comparison.bitwise_xor
Tensor.__invert__ = lambda self: comparison.bitwise_not(self)
Tensor.__getitem__ = manipulation.getitem
Tensor.__setitem__ = manipulation.setitem
