"""`jit.save` / `jit.load`: a captured program on disk — the port of
`paddle_tpu/jit/save_load.py`.

`save(layer, path, input_spec)` writes
- `<path>.pdiparams`: the parameters, then the buffers, each in name
  order, by `paddle.save` (`framework/io.py`), so the file is the JAX
  package's format and its weights load in either package;
- `<path>.pdmodel`: a pickle of plain values holding the port's program,
  a `torch.export` archive of the Layer's eval-mode forward with the
  parameters and buffers as inputs (`jit.to_static`'s capture), with
  each `None` / -1 size of an `InputSpec` exported as a dynamic size,
  and the names, input signature and output structure.

`load(path)` rebuilds the program on the expected place (the card unless
`set_device("cpu")`; a program saved from CPU tensors is moved to it by
`torch.export.passes.move_to_device_pass`) as a `TranslatedLayer`. The
kernels in it are the `torch.library` custom ops, which launch where the
program runs on CUDA tensors. The JAX package's `.pdmodel` is a
StableHLO program (`jax.export`), which the port cannot run: loading one
raises `ProgramFormatError`, which points to `paddle.load` of the
`.pdiparams`.
"""
from __future__ import annotations

import io
import pickle

import torch

from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from ..framework import io as fio
from ..framework.place import expected_device
from ..nn.layer.layers import Layer
from ..nn.parameter import Parameter
from .functional import buffer_arrays, state_arrays
from .to_static import InputSpec, StaticFunction, _unflatten_out, capture

__all__ = ["save", "load", "TranslatedLayer", "ProgramFormatError"]

FORMAT = "paddle_tpu_torch.export/1"


class ProgramFormatError(ValueError):
    """A `.pdmodel` the port cannot run (the JAX package's StableHLO, or
    not a program file at all)."""


def _example_inputs(input_spec, device):
    """(example torch tensors, dynamic shapes, avals) for the specs: a
    dynamic size takes 2 in the example (the exported program is valid
    for every size) and gets its own symbol."""
    if not input_spec:
        raise ValueError("jit.save needs input_spec")
    examples, dynamic, avals = [], [], []
    for i, spec in enumerate(input_spec):
        if isinstance(spec, Tensor):
            spec = InputSpec.from_tensor(spec)
        if not isinstance(spec, InputSpec):
            raise TypeError(f"jit.save: input_spec[{i}] is {type(spec)}")
        dims = {j: torch.export.Dim(f"d{i}_{j}")
                for j, s in enumerate(spec.shape) if s is None or s < 0}
        shape = [2 if j in dims else int(s)
                 for j, s in enumerate(spec.shape)]
        dt = dtype_mod.convert_dtype(spec.dtype)
        examples.append(torch.zeros(shape, dtype=dt.torch_dtype,
                                    device=device))
        dynamic.append(dims or None)
        avals.append(([f"d{i}_{j}" if j in dims else str(s)
                       for j, s in enumerate(spec.shape)], dt.name))
    return examples, dynamic, avals


def save(layer, path: str, input_spec=None, **configs):
    """Write `<path>.pdmodel` (the program) and `<path>.pdiparams` (the
    weights) of a Layer, or of a Layer's to_static forward, in eval
    mode."""
    if isinstance(layer, StaticFunction):
        target = layer._layer
    elif isinstance(layer, Layer):
        target = layer
    else:
        raise TypeError("jit.save expects a Layer or a to_static function")
    if input_spec is None:
        fwd = target.__dict__.get("forward")
        input_spec = getattr(layer, "_input_spec", None) or getattr(
            fwd, "_input_spec", None)
    was_training = target.training
    target.eval()
    try:
        params = dict(sorted(state_arrays(target).items()))
        buffers = dict(sorted(buffer_arrays(target).items()))
        first = next(iter(params.values()), None)
        device = first.device if first is not None else expected_device()
        examples, dynamic, avals = _example_inputs(input_spec, device)
        ep, struct = capture(target, target, list(params), list(buffers),
                             examples, {},
                             dynamic_shapes=((None,) * len(params),
                                             (None,) * len(buffers),
                                             tuple(dynamic)))
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        meta = {"format": FORMAT, "program": buf.getvalue(),
                "out_struct": struct, "param_names": list(params),
                "buffer_names": list(buffers), "input_avals": avals,
                "device": str(device)}
        with open(path + ".pdmodel", "wb") as f:
            pickle.dump(meta, f, protocol=4)
        fio.save({k: Tensor(v) for k, v in {**params, **buffers}.items()},
                 path + ".pdiparams")
    finally:
        if was_training:
            target.train()


class TranslatedLayer(Layer):
    """A loaded program (`python/paddle/jit/translated_layer.py` in the
    reference), callable like the Layer it was saved from; its
    parameters are `Parameter`s named with `.` as `__`."""

    def __init__(self, meta, weights, device):
        super().__init__()
        ep = torch.export.load(io.BytesIO(meta["program"]))
        if torch.device(meta["device"]) != device:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, device)
        self._program = ep.module()
        self._meta = meta
        self._param_list = []
        for name in meta["param_names"]:
            p = Parameter(weights[name]._data)
            self.add_parameter(name.replace(".", "__"), p)
            self._param_list.append(p)
        self._buffers_d = [weights[n] for n in meta["buffer_names"]]

    def forward(self, *inputs):
        arrays = [t._data if isinstance(t, Tensor) else Tensor(t)._data
                  for t in inputs]
        outs = self._program(tuple(p._data for p in self._param_list),
                             tuple(b._data for b in self._buffers_d),
                             *arrays)
        return _unflatten_out([Tensor._wrap(o) for o in outs],
                              self._meta["out_struct"])


def _read_program(path):
    try:
        with open(path, "rb") as f:
            meta = fio.loads_plain(f.read())
    except (pickle.UnpicklingError, EOFError, ValueError, TypeError,
            AttributeError, ImportError, IndexError) as e:
        raise ProgramFormatError(
            f"jit.load: {path} is not a saved program ({e})") from e
    if isinstance(meta, dict) and meta.get("format") == FORMAT:
        return meta
    if isinstance(meta, dict) and "stablehlo" in meta:
        raise ProgramFormatError(
            f"jit.load: {path} holds a StableHLO program written by the "
            f"JAX package (jax.export), which the port cannot run; load "
            f"its weights with paddle.load('<path>.pdiparams') into the "
            f"Layer's set_state_dict, then jit.save that Layer")
    raise ProgramFormatError(f"jit.load: {path} is not a saved program "
                             f"of the port (no {FORMAT!r} format tag)")


def load(path: str, **configs) -> TranslatedLayer:
    """The program at `<path>.pdmodel` with the weights of
    `<path>.pdiparams`, on the expected place."""
    meta = _read_program(path + ".pdmodel")
    weights = fio.load(path + ".pdiparams")
    return TranslatedLayer(meta, weights, expected_device())
