"""`functional_call`: run a Layer with tensors supplied from outside as its
parameters and buffers — the port of `paddle_tpu/jit/functional.py`.

The bridge between the eager Layer API and a captured program: swap each
parameter's and buffer's `_data` for a given `torch.Tensor` (a capture's
symbolic tensor, or a program's input), run the forward, restore.
`jit.to_static` and `jit.save` capture a Layer through it.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..core.tensor import Tensor

__all__ = ["functional_call", "state_arrays", "buffer_arrays"]


def state_arrays(layer) -> Dict[str, torch.Tensor]:
    """name -> torch tensor for every parameter."""
    return {name: p._data for name, p in layer.named_parameters()}


def buffer_arrays(layer) -> Dict[str, torch.Tensor]:
    return {name: b._data for name, b in layer.named_buffers()}


@contextlib.contextmanager
def _swapped(layer, params: Dict[str, torch.Tensor],
             buffers: Dict[str, torch.Tensor] = None):
    saved = {}
    named = dict(layer.named_parameters())
    named_buf = dict(layer.named_buffers())
    try:
        for name, arr in params.items():
            t = named.get(name)
            if t is None:
                raise KeyError(f"unknown parameter {name}")
            saved[id(t)] = (t, t._data)
            t._data = arr
        if buffers:
            for name, arr in buffers.items():
                t = named_buf.get(name)
                if t is None:
                    continue
                saved[id(t)] = (t, t._data)
                t._data = arr
        yield
    finally:
        for t, data in saved.values():
            t._data = data


def functional_call(layer, params: Dict[str, torch.Tensor], *args,
                    buffers: Dict[str, torch.Tensor] = None, **kwargs):
    """Run `layer(*args, **kwargs)` with `params` (and `buffers`) as its
    tensors. Plain torch tensors among `args` are wrapped as Tensors that
    keep their autograd state."""
    wrapped = [a if isinstance(a, Tensor) else Tensor._wrap(a)
               if isinstance(a, torch.Tensor) else Tensor(a) for a in args]
    with _swapped(layer, params, buffers):
        return layer(*wrapped, **kwargs)
