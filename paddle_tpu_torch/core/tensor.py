"""The eager Tensor: the port of `paddle_tpu/core/tensor.py`.

A `Tensor` is a handle over one `torch.Tensor` (`_data`) with paddle's
surface. It is not a `torch.Tensor` subclass, so it never leaks into the
port's engines, which hand plain tensors around. Autograd is torch's:
- `stop_gradient` (default True) is `not _data.requires_grad` for float
  tensors; setting it True on a non-leaf swaps `_data` for a detached
  view, which cuts the graph there. Integer tensors never carry
  gradients and keep the flag alone.
- `grad` is the leaf's accumulated `_data.grad`, wrapped, or the
  `SelectedRows` that `Embedding(sparse=True)` accumulates beside it
  (`_sr`); `register_hook` wraps torch's hook (a leaf hook's return value
  replaces the cotangent before accumulation).
- `numpy()` gives a copy; of a bfloat16 tensor an `ml_dtypes.bfloat16`
  array of the same bits where `ml_dtypes` imports (as the JAX package's does),
  and raises otherwise, naming `astype`: it never converts silently.

Under lazy mode (`core/lazy.py`) an op's output is a pending Tensor:
its `_data` is a `lazy.LazyArray`, which answers shape, dtype, device
and the like without running anything and runs the pending graph when
anything else reads it (a torch function, a method, `numpy()`); the
flush then swaps the value into every Tensor that holds it. A pending
Tensor keeps its own stop_gradient until then.

The op methods and dunders are attached by `paddle_tpu_torch.ops`.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.place import Place, expected_device
from . import autograd
from .lazy import LazyArray as _LazyArray

__all__ = ["Tensor", "DataDependentError"]

_name_counter = itertools.count()


class DataDependentError(RuntimeError):
    """A Tensor's values were read (`numpy()`, `tolist()`) while a program
    was being captured (`jit.to_static`, `jit.save`), where tensors have
    shapes but no values: the signal of a data-dependent Python branch."""


def _to_torch(data, device=None) -> torch.Tensor:
    """A new torch tensor from numpy / Python data on `device` (the
    expected place by default)."""
    if not isinstance(data, np.ndarray):
        data = np.asarray(data)
    if data.dtype.kind == "V" or data.dtype.name in ("bfloat16",
                                                     "float8_e4m3fn",
                                                     "float8_e5m2"):
        # an ml_dtypes array: same bits through an integer view
        dt = dtype_mod.convert_dtype(data.dtype.name)
        t = torch.from_numpy(np.ascontiguousarray(data).view(
            f"int{data.dtype.itemsize * 8}").copy()).view(dt.torch_dtype)
    else:
        t = torch.from_numpy(np.array(data, copy=True))
    return t.to(expected_device(device))


class Tensor:
    __slots__ = ("_data", "_sg", "_grad_wrap", "name", "persistable",
                 "__weakref__", "__dict__")

    def __init__(self, data, stop_gradient: bool = True,
                 name: Optional[str] = None, place=None):
        if isinstance(data, Tensor):
            data = data._data.detach()
        elif isinstance(data, _LazyArray):
            data = data.materialize().detach()
        elif not isinstance(data, torch.Tensor):
            data = _to_torch(data, place)
        else:
            # a view of its own: its autograd flags are not the caller's
            data = data.detach()
        self._data = data
        self._sg = True
        self._grad_wrap = None
        self.name = name or f"tensor_{next(_name_counter)}"
        self.persistable = False
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, data: torch.Tensor) -> "Tensor":
        """Wrap an op's output as is: its autograd state is the Tensor's."""
        t = cls.__new__(cls)
        t._data = data
        t._sg = True
        t._grad_wrap = None
        t.name = f"tensor_{next(_name_counter)}"
        t.persistable = False
        return t

    # -- metadata ----------------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    dim = ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self) -> dtype_mod.DType:
        return dtype_mod.from_torch(self._data.dtype)

    @property
    def place(self) -> Place:
        return Place.of(self._data.device)

    @property
    def stop_gradient(self) -> bool:
        d = self._data
        if type(d) is _LazyArray:
            return self._sg     # a pending Tensor's own flag
        return self._sg and not d.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        v = bool(v)
        d = self._data
        if type(d) is _LazyArray:
            # applied to the value when the graph flushes
            self._sg = v
            return
        if v and d.requires_grad:
            if d.grad_fn is None:
                d.requires_grad_(False)
            else:
                self._data = d.detach()
        elif not v and not d.requires_grad \
                and dtype_mod.is_inexact(d.dtype):
            d.requires_grad_(True)
        self._sg = v

    @property
    def is_leaf(self) -> bool:
        if type(self._data) is _LazyArray:
            return self._sg
        return self._data.grad_fn is None

    # -- grad --------------------------------------------------------------
    # a row-sparse gradient (`core/selected_rows.py`) accumulated by
    # `Embedding(sparse=True)`'s backward beside the leaf's dense `.grad`
    _sr = None

    @property
    def grad(self):
        """The accumulated gradient: a Tensor, or a `SelectedRows` when
        only sparse lookups reached this leaf. Sparse and dense
        contributions together densify (the dense sum plus the rows)."""
        g = self._data.grad if self._data.is_leaf else None
        sr = self._sr
        if sr is not None:
            if g is None:
                return sr
            self._data.grad = g = g + sr.to_dense().to(g.dtype)
            self._sr = None
        if g is None:
            return None
        w = self._grad_wrap
        if w is None or w._data is not g:
            w = self._grad_wrap = Tensor._wrap(g)
        return w

    @grad.setter
    def grad(self, g):
        if getattr(g, "is_selected_rows", False):
            self._sr = g
            self._data.grad = None
            return
        self._sr = None
        self._data.grad = None if g is None else (
            g._data if isinstance(g, Tensor) else torch.as_tensor(g))

    def backward(self, grad_tensor=None, retain_graph=False):
        autograd.run_backward([self], [grad_tensor],
                              retain_graph=retain_graph)

    def clear_gradient(self, set_to_zero: bool = False):
        """Drop the gradient, or (`set_to_zero`) zero it; a SelectedRows
        gradient zeroes to dense zeros of the full shape."""
        sr, self._sr = self._sr, None
        g = self._data.grad
        if set_to_zero and g is None and sr is not None:
            g = torch.zeros(sr.shape, dtype=sr.values.dtype,
                            device=sr.values.device)
        self._data.grad = torch.zeros_like(g) \
            if set_to_zero and g is not None else None

    clear_grad = clear_gradient

    def register_hook(self, hook):
        """Call `hook(grad)` with this tensor's cotangent; a Tensor it
        returns replaces the cotangent. Returns a handle with
        `remove()`."""
        if type(self._data) is _LazyArray:
            # a hooked intermediate must be a region output with a real
            # tape edge
            from . import lazy

            lazy.sync(reason="hook")
        if self.stop_gradient:
            raise RuntimeError("cannot register hook on a tensor that stops "
                               "gradient")

        def torch_hook(g):
            r = hook(Tensor._wrap(g))
            if r is None:
                return None
            return r._data if isinstance(r, Tensor) else torch.as_tensor(
                r, dtype=g.dtype, device=g.device)

        return self._data.register_hook(torch_hook)

    # -- conversion --------------------------------------------------------
    def numpy(self) -> np.ndarray:
        if torch.compiler.is_exporting():
            raise DataDependentError(
                "Tensor.numpy(): a captured program has no values to read "
                "(data-dependent Python control flow)")
        d = self._data.detach()
        # a copy, as paddle's numpy() gives: the optimizers and
        # set_state_dict write parameters in place
        d = d.cpu() if d.device.type != "cpu" else d.clone()
        dt = self.dtype
        if d.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            if dt.np_dtype is None:
                raise TypeError(
                    f"Tensor.numpy(): numpy has no {dt.name} without "
                    f"ml_dtypes; convert first, e.g. "
                    f"t.astype('float32').numpy()")
            ints = {2: torch.int16, 1: torch.int8}[d.element_size()]
            return d.contiguous().view(ints).numpy().view(dt.np_dtype)
        return d.numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __int__(self):
        return int(self.item())

    def __float__(self):
        return float(self.item())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of a multi-element Tensor is "
                             "ambiguous")
        return bool(self.item())

    def __index__(self):
        return int(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._data.shape[0]

    def __iter__(self):
        if self.ndim == 0:
            raise TypeError("iteration over a 0-D tensor")
        for i in range(self._data.shape[0]):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def detach(self) -> "Tensor":
        d = self._data
        if type(d) is _LazyArray and d._concrete is None:
            return d.new_owner(stop_gradient=True)
        return Tensor._wrap(d.detach())

    def detach_(self):
        self.stop_gradient = True
        return self

    def clone(self) -> "Tensor":
        from .. import ops

        return ops.assign(self)

    def cpu(self) -> "Tensor":
        return Tensor._wrap(self._data.cpu())

    def to(self, *args, **kwargs) -> "Tensor":
        """`.to(dtype)`, `.to(device)`, `.to(device, dtype)`, or the
        `device=` / `dtype=` keywords."""
        t = self
        dev = kwargs.get("device")
        dt = kwargs.get("dtype")
        for a in args:
            if isinstance(a, (Place, torch.device)) or _looks_like_device(a):
                dev = a
            else:
                dt = a
        if dev is not None:
            d = expected_device(dev)
            if d != t._data.device:
                t = Tensor._wrap(t._data.to(d))
        if dt is not None:
            t = t.astype(dt)
        return t

    # -- misc --------------------------------------------------------------
    def set_value(self, value):
        """Overwrite the values in place, keeping shape, dtype and device."""
        v = value._data if isinstance(value, Tensor) else torch.as_tensor(
            np.asarray(value))
        with torch.no_grad():
            self._data.copy_(v.to(self._data.dtype).reshape(self._data.shape))
        return self

    def get_tensor(self):
        return self

    def value(self):
        return self

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        try:
            body = self.numpy()
        except TypeError:
            body = self._data.detach().cpu().float().numpy()
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad_info},\n       {body})")

    __str__ = __repr__

    def __hash__(self):
        return id(self)


def _looks_like_device(s):
    return isinstance(s, str) and s.split(":")[0] in ("cpu", "gpu", "cuda")
