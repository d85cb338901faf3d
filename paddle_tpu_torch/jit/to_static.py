"""`@to_static`: whole-program capture — the port of
`paddle_tpu/jit/to_static.py`.

As in the JAX package, the forward is captured once per input signature
(each tensor's shape, dtype and device, the static keyword arguments,
`training`, and the parameters' and buffers' shapes, dtypes and devices)
into one program that takes the parameters and buffers as inputs. The
JAX package traces it into one XLA executable; here the capture is a
non-strict `torch.export` of `functional_call` over the Layer's tensors,
and the exported graph module runs under torch autograd, so a step's
backward reaches every parameter's `.grad`. The hand-written kernels are
`torch.library` custom ops (`paddle_tpu_torch::flash_attention`,
`::flash_attention_backward`, `::rms_norm`): the program records them by
name, and each picks its route where it runs (the kernel on CUDA
tensors, its plain version on CPU tensors); their launch counters move
only when they run, never at capture. A random draw inside the forward
(dropout's key) is taken once at capture and fixed in the program, as a
traced JAX program fixes it.

Graph breaks: a data-dependent Python branch (`float(t)`, `bool(t)`,
`t.numpy()` on a captured tensor) cannot live in one program. The
capture raises then; the signature warns once ("data-dependent") and runs
eagerly from then on, so the model still trains.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..core.tensor import DataDependentError, Tensor
from .functional import _swapped

__all__ = ["to_static", "not_to_static", "StaticFunction", "InputSpec",
           "ignore_module"]


def _graph_break_errors():
    """The errors a capture raises at a data-dependent Python branch."""
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)

    return (GuardOnDataDependentSymNode, DataDependentError)


class InputSpec:
    """`paddle.static.InputSpec`: a shape (None or -1 for a dynamic size),
    a dtype and a name."""

    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, " \
               f"name={self.name})"

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype.name, name)


def _flatten_out(out):
    """-> (list of Tensors, structure template with int placeholders)."""
    flat: List[Tensor] = []

    def rec(o):
        if isinstance(o, Tensor):
            flat.append(o)
            return len(flat) - 1
        if isinstance(o, (list, tuple)):
            return type(o)(rec(x) for x in o)
        if isinstance(o, dict):
            return {k: rec(v) for k, v in o.items()}
        return ("__const__", o)

    return flat, rec(out)


def _unflatten_out(outs, struct):
    def rec(s):
        if isinstance(s, int):
            return outs[s]
        if isinstance(s, tuple) and len(s) == 2 and s[0] == "__const__":
            return s[1]
        if isinstance(s, (list, tuple)):
            return type(s)(rec(x) for x in s)
        if isinstance(s, dict):
            return {k: rec(v) for k, v in s.items()}
        return s

    return rec(struct)


class _Capture(torch.nn.Module):
    """The function over flat torch tensors that `torch.export` captures:
    `forward(params, buffers, *inputs)` swaps the parameters and buffers
    in, calls `fn` on the inputs wrapped as Tensors, and returns the
    flat output tensors; the output structure goes into `struct[0]` (a
    list outside the module: the capture restores module attributes)."""

    def __init__(self, fn, layer, param_names, buffer_names, kwargs,
                 struct):
        super().__init__()
        self._fn, self._target, self._kwargs = fn, layer, kwargs
        self._names = (param_names, buffer_names)
        self._struct = struct

    def forward(self, params, buffers, *inputs):
        layer = self._target
        wrapped = [Tensor._wrap(a) for a in inputs]
        if layer is None:
            out = self._fn(*wrapped, **self._kwargs)
        else:
            with _swapped(layer, dict(zip(self._names[0], params)),
                          dict(zip(self._names[1], buffers))):
                out = self._fn(*wrapped, **self._kwargs)
        flat, self._struct[0] = _flatten_out(out)
        return tuple(t._data for t in flat)


def capture(fn, layer, param_names, buffer_names, example_inputs, kwargs,
            dynamic_shapes=None):
    """Export `fn` (over `layer`'s named tensors, or none) on the example
    torch tensors: returns (the `ExportedProgram`, the output structure)."""
    struct = [None]
    mod = _Capture(fn, layer, param_names, buffer_names, kwargs, struct)
    named = {} if layer is None else dict(layer.named_parameters())
    named_buf = {} if layer is None else dict(layer.named_buffers())
    args = (tuple(named[n]._data for n in param_names),
            tuple(named_buf[n]._data for n in buffer_names),
            *example_inputs)
    ep = torch.export.export(mod, args, dynamic_shapes=dynamic_shapes,
                             strict=False)
    # the program keeps no example tensors: they would pin the capture's
    # inputs, and `torch.export.save` would write every weight with them
    ep.example_inputs = None
    return ep, struct[0]


def _signature(tensors):
    return tuple((tuple(t._data.shape), t._data.dtype, t._data.device)
                 for t in tensors)


class StaticFunction:
    """A callable captured per input signature
    (`program_translator.py:2178` in the reference)."""

    def __init__(self, function: Callable, layer=None, input_spec=None,
                 build_strategy=None, backend=None, full_graph=True):
        self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._programs: Dict[tuple, Any] = {}
        self._fallback_keys: set = set()  # signatures that graph-broke
        self.__name__ = getattr(function, "__name__", "static_fn")

    def _named(self):
        if self._layer is None:
            return [], []
        return (sorted(self._layer.named_parameters()),
                sorted(self._layer.named_buffers()))

    def __call__(self, *args, **kwargs):
        if torch.compiler.is_exporting():
            # inside another capture (`jit.save` of a to_static Layer):
            # the outer program records this call's operations
            return self._function(*args, **kwargs)
        tensor_args = []
        for a in args:
            if isinstance(a, Tensor):
                tensor_args.append(a)
            elif isinstance(a, (np.ndarray, list)):
                tensor_args.append(Tensor(np.asarray(a)))
            else:
                raise NotImplementedError(
                    "to_static supports non-tensor positional args only as "
                    "keyword arguments")
        for k, v in kwargs.items():
            if isinstance(v, Tensor):
                raise NotImplementedError(
                    "pass Tensors positionally to a to_static function")
        training = bool(self._layer.training) if self._layer is not None \
            else True
        params, buffers = self._named()
        key = (_signature(tensor_args), tuple(sorted(kwargs.items())),
               training, _signature([t for _, t in params + buffers]))
        if key in self._fallback_keys:  # the eager path for good
            return self._function(*tensor_args, **kwargs)
        prog = self._programs.get(key)
        if prog is None:
            try:
                ep, struct = capture(
                    self._function, self._layer, [n for n, _ in params],
                    [n for n, _ in buffers],
                    [t._data for t in tensor_args], dict(kwargs))
            except _graph_break_errors() as e:
                # the SOT graph break: the forward branches on a tensor
                # VALUE (if t.item(): / float(t) / t.numpy()), which one
                # captured program cannot hold
                warnings.warn(
                    f"to_static({self.__name__}): data-dependent Python "
                    f"control flow broke whole-program capture "
                    f"({type(e).__name__}); falling back to eager "
                    f"execution for this input signature.", stacklevel=2)
                self._fallback_keys.add(key)
                return self._function(*tensor_args, **kwargs)
            prog = self._programs[key] = (ep.module(), struct)
        module, struct = prog
        outs = module(tuple(t._data for _, t in params),
                      tuple(t._data for _, t in buffers),
                      *[t._data for t in tensor_args])
        return _unflatten_out([Tensor._wrap(o) for o in outs], struct)

    # -- reference-parity helpers -------------------------------------------
    @property
    def forward(self):
        return self

    def concrete_program_specify_input_spec(self, *a, **k):
        return None

    def rollback(self):
        return self._function


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """Capture a function or a Layer (`paddle.jit.to_static`); a Layer's
    forward is replaced and the Layer returned."""

    def wrap(fn):
        from ..nn.layer.layers import Layer

        if isinstance(fn, Layer):
            fn.forward = StaticFunction(fn.forward, layer=fn,
                                        input_spec=input_spec,
                                        build_strategy=build_strategy)
            return fn
        return StaticFunction(fn, layer=getattr(fn, "__self__", None),
                              input_spec=input_spec,
                              build_strategy=build_strategy)

    if function is not None:
        return wrap(function)
    return wrap


def not_to_static(fn=None):
    """Mark a function to stay eager (`paddle.jit.not_to_static`)."""
    if fn is None:
        return lambda f: f
    return fn


def ignore_module(modules):
    return None
