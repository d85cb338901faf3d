"""Eager op dispatch: the port of `paddle_tpu/core/dispatch.py`.

An op is a registered torch function `fn(*tensors, **attrs)`.
`apply(op_name, tensor_inputs, attrs)` unwraps the `Tensor` inputs, runs
the function under torch's grad mode (torch autograd records it when an
input requires grad), and wraps the outputs: an output stops gradient
unless torch recorded it, so integer and bool outputs always stop. The
hook points of the JAX dispatcher stay: the AMP input rewrite
(`set_amp_hook`), the lazy recorder (`core/lazy.py`: with lazy mode on,
`apply` records the op and returns pending Tensors; an op it declines
runs now, and reading a pending input's `_data` flushes it first), the
op observers (`add_op_observer`) and the `FLAGS_check_nan_inf` check.

The JAX dispatcher caches one compiled executable per op signature
(`cache_stats`, `clear_caches`); an eager PyTorch op has nothing to
compile, so those have no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..framework import flags
from ..framework.dtype import is_inexact
from . import lazy as _lazy
from .tensor import Tensor

__all__ = ["OpDef", "register_op", "get_op", "op_registry", "apply",
           "set_amp_hook", "add_op_observer", "remove_op_observer"]

_OP_REGISTRY: Dict[str, "OpDef"] = {}

flags.define_flag("check_nan_inf", False,
                  "run nan/inf checks after every eager op")
flags.define_flag("check_nan_inf_level", 0,
                  "0: error on nan/inf; >=1: log only")

# AMP input rewrite installed by an `amp` module: (op_name, inputs) ->
# inputs
_amp_hook: Optional[Callable] = None
# observers fed (op_name, output Tensors)
_op_observers: list = []


def set_amp_hook(fn: Optional[Callable]):
    global _amp_hook
    _amp_hook = fn


def add_op_observer(fn: Callable):
    _op_observers.append(fn)


def remove_op_observer(fn: Callable):
    if fn in _op_observers:
        _op_observers.remove(fn)


class OpDef:
    """One operator: a torch function `fn(*tensors, **attrs)`;
    `multi_out` marks one that returns a tuple."""

    __slots__ = ("name", "fn", "multi_out")

    def __init__(self, name: str, fn: Callable, multi_out: bool = False):
        self.name = name
        self.fn = fn
        self.multi_out = multi_out


def register_op(name: str, fn: Callable = None, *, multi_out: bool = False):
    """Register an op; usable as a decorator or a direct call."""

    def deco(f):
        _OP_REGISTRY[name] = OpDef(name, f, multi_out=multi_out)
        return f

    if fn is not None:
        return deco(fn)
    return deco


def get_op(name: str) -> OpDef:
    return _OP_REGISTRY[name]


def op_registry() -> Dict[str, OpDef]:
    return _OP_REGISTRY


def apply(op_name: str, tensor_inputs: Sequence, attrs: Optional[dict] = None):
    """Run one op on Tensor inputs; returns a Tensor, or a list of them
    for a tuple-returning op."""
    op = _OP_REGISTRY[op_name]
    if _amp_hook is not None:
        tensor_inputs = _amp_hook(op_name, tensor_inputs)
    if _lazy._ACTIVE:
        if _lazy.is_lazy_enabled():
            out = _lazy.try_record(op, tensor_inputs, attrs or {})
            if out is not _lazy.NOT_HANDLED:
                return out
        # a pending input consumed here runs its graph first (with its
        # own stop_gradient)
        out = op.fn(*[_lazy.materialize(t) if isinstance(t, Tensor) else t
                      for t in tensor_inputs], **(attrs or {}))
    else:
        out = op.fn(*[t._data if isinstance(t, Tensor) else t
                      for t in tensor_inputs], **(attrs or {}))
    if isinstance(out, (tuple, list)):
        res = [Tensor._wrap(o) for o in out]
        _check_outputs(op_name, res)
        return res
    res = Tensor._wrap(out)
    _check_outputs(op_name, [res])
    return res


def _check_outputs(name, tensors):
    """The op observers, then `FLAGS_check_nan_inf`
    (`fluid/eager/nan_inf_utils.h:38`): a NaN or Inf in a float output
    raises (level 0) or is printed."""
    for obs in _op_observers:
        obs(name, tensors)
    if not flags.flag_value("check_nan_inf"):
        return
    for t in tensors:
        d = t._data
        if is_inexact(d.dtype) and not bool(torch.isfinite(d).all()):
            msg = f"Op {name} produced NaN/Inf in output {t.shape}"
            if flags.flag_value("check_nan_inf_level") == 0:
                raise FloatingPointError(msg)
            print("[paddle_tpu_torch][nan_inf]", msg)
