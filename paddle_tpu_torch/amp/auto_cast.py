"""Auto mixed precision: the `auto_cast` guard and `decorate`, the port of
`paddle_tpu/amp/auto_cast.py`.

One rewrite, installed into `core.dispatch.apply` through
`dispatch.set_amp_hook` while a guard is on, casts each op's Tensor
inputs through the registered `cast` op, so the tape holds real cast
nodes and gradients cast themselves back to the parameters' dtype. The
rule (`_target_dtype`, `_amp_rewrite`): an op of the black list computes
in float32; under O2 every other op computes in the AMP dtype; under O1
a white-list op does, and a gray op (in neither list) with float32 among
its float inputs promotes the low-precision ones to float32; OD runs the
white list low and every gray op in float32. Under lazy mode the casts
are recorded ops like any other.

`decorate(level="O2")` casts the float32 parameters and buffers of every
layer but the norms (`need_keep_fp32`) to the AMP dtype and turns on the
optimizer's float32 master weights. The RMSNorm op is black-listed, so
under `auto_cast` its x and its float32 weight reach the kernel in one
dtype.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..core import dispatch
from ..core.tensor import Tensor
from .amp_lists import _EXCLUDED, AutoMixedPrecisionLists

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate", "amp_state",
           "is_bfloat16_supported", "is_float16_supported",
           "need_keep_fp32"]

_LOW = (torch.float16, torch.bfloat16)
_CASTABLE = _LOW + (torch.float32,)


class _AmpState:
    __slots__ = ("enabled", "level", "dtype", "lists", "use_promote", "od")

    def __init__(self):
        self.enabled = False
        self.level = "O0"
        self.dtype = torch.bfloat16
        self.lists = None
        self.use_promote = True
        self.od = False


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def in_amp_guard() -> bool:
    return _state.enabled


def amp_level() -> str:
    return _state.level if _state.enabled else "O0"


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return str(device).split(":")[0].replace("gpu", "cuda")


def is_bfloat16_supported(device=None) -> bool:
    """Whether the device computes in bfloat16 (the CPU does)."""
    if _device_type(device) == "cuda":
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(device=None) -> bool:
    """Whether float16 AMP is supported: on a CUDA card, not on the CPU
    (as the JAX package answers for its CPU backend)."""
    return _device_type(device) == "cuda" and torch.cuda.is_available()


def _cast(t: Tensor, dtype) -> Tensor:
    from ..ops import manipulation

    return manipulation.cast(t, dtype)


def _target_dtype(op_name: str, state: _AmpState) -> Optional[torch.dtype]:
    """None: leave the inputs alone; else the dtype to compute in."""
    if op_name in _EXCLUDED:
        return None
    lists = state.lists
    if op_name in lists.black_list:
        return torch.float32
    if state.level == "O2":
        return state.dtype
    if op_name in lists.white_list:
        return state.dtype
    if state.od:  # OD: white list only, every gray op in float32
        return torch.float32
    return None  # gray op: promotion below


def _amp_rewrite(op_name: str, tensor_inputs):
    state = _state
    if not state.enabled:
        return tensor_inputs
    target = _target_dtype(op_name, state)
    if target is None:
        if not state.use_promote or op_name in _EXCLUDED:
            return tensor_inputs
        # a gray op with mixed float precision: promote the low-precision
        # inputs to float32 (the widest present)
        dts = [t._data.dtype for t in tensor_inputs
               if isinstance(t, Tensor) and t._data.dtype in _CASTABLE]
        if not dts or torch.float32 not in dts:
            return tensor_inputs
        target = torch.float32
    out = []
    for t in tensor_inputs:
        if isinstance(t, Tensor):
            dt = t._data.dtype      # a pending Tensor's too, with no flush
            if dt in _CASTABLE and dt != target:
                t = _cast(t, target)
        out.append(t)
    return out


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """The mixed-precision guard (`paddle.amp.auto_cast`); bfloat16 by
    default."""
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"level must be O0/OD/O1/O2, got {level}")
    if dtype not in ("float16", "bfloat16"):
        raise ValueError(f"amp dtype must be float16/bfloat16, got {dtype}")
    prev = (_state.enabled, _state.level, _state.dtype, _state.lists,
            _state.use_promote, _state.od)
    _state.enabled = bool(enable) and level != "O0"
    _state.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    _state.lists = AutoMixedPrecisionLists(
        custom_white_list=custom_white_list,
        custom_black_list=custom_black_list, dtype=dtype)
    _state.od = level == "OD"
    _state.level = "O1" if level == "OD" else level
    _state.use_promote = True if level == "OD" else bool(use_promote)
    dispatch.set_amp_hook(_amp_rewrite if _state.enabled else None)
    try:
        yield
    finally:
        (_state.enabled, _state.level, _state.dtype, _state.lists,
         _state.use_promote, _state.od) = prev
        dispatch.set_amp_hook(_amp_rewrite if _state.enabled else None)


amp_guard = auto_cast


def need_keep_fp32(layer) -> bool:
    """Normalization layers keep float32 parameters under O2."""
    name = type(layer).__name__
    return any(k in name for k in
               ("BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm",
                "SyncBatchNorm", "LocalResponseNorm", "RMSNorm"))


def _cast_layer_params(layer, dtype, excluded=()):
    from ..nn.layer.layers import _rebind

    for sub in layer.sublayers(include_self=True):
        if need_keep_fp32(sub):
            continue
        if excluded and (isinstance(sub, tuple(t for t in excluded
                                               if isinstance(t, type)))
                         or any(sub is e for e in excluded
                                if not isinstance(e, type))):
            continue
        for p in list(sub.parameters(include_sublayers=False)):
            if p._data.dtype == torch.float32:
                _rebind(p, p._data.to(dtype))
        for _, b in sub.named_buffers(include_sublayers=False):
            if b._data.dtype == torch.float32:
                _rebind(b, b._data.to(dtype))


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """`paddle.amp.decorate`: under O2, cast the non-norm parameters to
    the AMP dtype and switch the optimizers to float32 master weights."""
    if level not in ("O1", "O2"):
        raise ValueError("decorate level must be O1 or O2")
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        excluded = tuple(excluded_layers or ())
        for m in model_list:
            _cast_layer_params(m, tdtype, excluded)
    if optimizers is not None:
        single_opt = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if single_opt else list(optimizers)
        if level == "O2" and master_weight is not False:
            for opt in opt_list:
                opt._use_master_weights = True
        ret_opt = opt_list[0] if single_opt else opt_list
        return (model_list[0] if single_model else model_list), ret_opt
    return model_list[0] if single_model else model_list


amp_decorate = decorate
