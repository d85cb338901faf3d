"""Operators of the port: the eager ops over `Tensor` (creation, math,
manipulation, comparison, reduction, activation, linear algebra and the
extended surface of `paddle_tpu/ops/extended.py`), attached to `Tensor`
as methods and dunders here as the JAX package's `ops/__init__.py`
attaches them, with the in-place `_` forms of the JAX package's table
(`extended._INPLACE`); the serving sampler (`ops.sampling`); and the
hand-written kernels (`ops.kernels`)."""
from __future__ import annotations

from ..core.tensor import Tensor
from . import (activation, comparison, creation, extended, linalg,
               manipulation, math, reduction)
from .comparison import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .extended import *  # noqa: F401,F403
from .extended import _INPLACE

# the activations after math's names: `paddle.sigmoid` is the
# activation's (op `sigmoid_act`), as in the JAX package, and
# `paddle.tanh` stays math's
_ACTIVATIONS = [n for n in activation.__all__ if n != "tanh"]
globals().update({n: getattr(activation, n) for n in _ACTIVATIONS})
_INTERNAL = {"getitem", "setitem"}
# the linalg functions the top level exports too, as the JAX package's
# `ops/__init__.py` imports them
_LINALG_TOP = ["bincount", "bmm", "cholesky", "cholesky_solve", "cond",
               "corrcoef", "cov", "cross", "det", "dist", "dot", "eig",
               "eigh", "eigvals", "eigvalsh", "einsum", "histogram", "inv",
               "inverse", "lstsq", "lu", "matmul", "matrix_power",
               "matrix_rank", "matrix_transpose", "mm", "multi_dot", "mv",
               "norm", "pinv", "qr", "slogdet", "solve", "svd",
               "triangular_solve"]
globals().update({n: getattr(linalg, n) for n in _LINALG_TOP})

__all__ = sorted((set(math.__all__) | set(comparison.__all__)
                  | set(creation.__all__) | set(manipulation.__all__)
                  | set(reduction.__all__) | set(_ACTIVATIONS)
                  | set(_LINALG_TOP) | set(extended.__all__)) - _INTERNAL)

_METHODS = dict(
    # math
    add=math.add, subtract=math.subtract, multiply=math.multiply,
    divide=math.divide, floor_divide=math.floor_divide,
    remainder=math.remainder, mod=math.remainder, pow=math.pow,
    maximum=math.maximum, minimum=math.minimum, exp=math.exp, log=math.log,
    log2=math.log2, log10=math.log10, log1p=math.log1p, sqrt=math.sqrt,
    rsqrt=math.rsqrt, abs=math.abs, sign=math.sign, floor=math.floor,
    ceil=math.ceil, round=math.round, trunc=math.trunc, square=math.square,
    reciprocal=math.reciprocal, neg=math.neg, sin=math.sin, cos=math.cos,
    tan=math.tan, asin=math.asin, acos=math.acos, atan=math.atan,
    sinh=math.sinh, cosh=math.cosh, tanh=math.tanh, asinh=math.asinh,
    acosh=math.acosh, atanh=math.atanh, erf=math.erf, sigmoid=math.sigmoid,
    isnan=math.isnan, isinf=math.isinf, isfinite=math.isfinite,
    clip=math.clip, clip_=math.clip_, scale=math.scale, scale_=math.scale_,
    lerp=math.lerp, cumsum=math.cumsum, cumprod=math.cumprod,
    logcumsumexp=math.logcumsumexp, add_=math.add_,
    subtract_=math.subtract_, multiply_=math.multiply_, kron=math.kron,
    outer=math.outer, atan2=math.atan2, digamma=math.digamma,
    lgamma=math.lgamma, angle=math.angle, conj=math.conj, real=math.real,
    imag=math.imag, deg2rad=math.deg2rad, rad2deg=math.rad2deg,
    diff=math.diff, nan_to_num=math.nan_to_num, addmm=math.addmm,
    # reduction
    sum=reduction.sum, mean=reduction.mean, max=reduction.max,
    min=reduction.min, amax=reduction.amax, amin=reduction.amin,
    prod=reduction.prod, all=reduction.all, any=reduction.any,
    argmax=reduction.argmax, argmin=reduction.argmin,
    logsumexp=reduction.logsumexp, std=reduction.std, var=reduction.var,
    median=reduction.median, nanmean=reduction.nanmean,
    nansum=reduction.nansum, nanmedian=reduction.nanmedian,
    count_nonzero=reduction.count_nonzero, quantile=reduction.quantile,
    # comparison
    equal=comparison.equal, not_equal=comparison.not_equal,
    greater_than=comparison.greater_than,
    greater_equal=comparison.greater_equal,
    less_than=comparison.less_than, less_equal=comparison.less_equal,
    logical_and=comparison.logical_and, logical_or=comparison.logical_or,
    logical_xor=comparison.logical_xor,
    logical_not=comparison.logical_not,
    bitwise_and=comparison.bitwise_and, bitwise_or=comparison.bitwise_or,
    bitwise_xor=comparison.bitwise_xor,
    bitwise_not=comparison.bitwise_not, isclose=comparison.isclose,
    allclose=comparison.allclose, equal_all=comparison.equal_all,
    bitwise_left_shift=comparison.bitwise_left_shift,
    bitwise_right_shift=comparison.bitwise_right_shift,
    is_empty=comparison.is_empty,
    # linalg
    matmul=linalg.matmul, mm=linalg.mm, bmm=linalg.bmm, dot=linalg.dot,
    norm=linalg.norm, dist=linalg.dist, cross=linalg.cross,
    cholesky=linalg.cholesky, inverse=linalg.inverse, det=linalg.det,
    t=manipulation.t, matrix_power=linalg.matrix_power,
    # manipulation
    reshape=manipulation.reshape, reshape_=manipulation.reshape_,
    transpose=manipulation.transpose, flatten=manipulation.flatten,
    squeeze=manipulation.squeeze, squeeze_=manipulation.squeeze_,
    unsqueeze=manipulation.unsqueeze, unsqueeze_=manipulation.unsqueeze_,
    cast=manipulation.cast, astype=manipulation.cast,
    split=manipulation.split, chunk=manipulation.chunk,
    unbind=manipulation.unbind, tile=manipulation.tile,
    expand=manipulation.expand, expand_as=manipulation.expand_as,
    broadcast_to=manipulation.broadcast_to, flip=manipulation.flip,
    roll=manipulation.roll, gather=manipulation.gather,
    gather_nd=manipulation.gather_nd, scatter=manipulation.scatter,
    scatter_nd_add=manipulation.scatter_nd_add,
    index_select=manipulation.index_select,
    index_sample=manipulation.index_sample,
    masked_select=manipulation.masked_select,
    masked_fill=manipulation.masked_fill, where=manipulation.where,
    topk=manipulation.topk, sort=manipulation.sort,
    argsort=manipulation.argsort, nonzero=manipulation.nonzero,
    unique=manipulation.unique, numel=manipulation.numel,
    take_along_axis=manipulation.take_along_axis,
    put_along_axis=manipulation.put_along_axis,
    diagonal=manipulation.diagonal, moveaxis=manipulation.moveaxis,
    swapaxes=manipulation.swapaxes,
    repeat_interleave=manipulation.repeat_interleave, pad=manipulation.pad,
    slice=manipulation.slice, select_scatter=manipulation.select_scatter,
    where_=manipulation.where_,
    # activations as methods (paddle has some)
    softmax=activation.softmax, relu=activation.relu,
)
_METHODS.update(_INPLACE)

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
