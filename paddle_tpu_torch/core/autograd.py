"""The eager autograd API: the port of `paddle_tpu/core/autograd.py` over
torch autograd.

The JAX package records its own tape; here torch autograd is the tape,
and paddle's semantics are kept at its edges:
- grad mode (`no_grad`, `enable_grad`, `set_grad_enabled`,
  `is_grad_enabled`) is torch's own;
- `run_backward` (`Tensor.backward`) seeds a tensor of any shape with
  ones, skips outputs that stop gradient, and raises `RuntimeError` on a
  second backward through freed buffers (torch's own error);
- `grad` (`paddle.grad`) leaves every `.grad` alone, retains the graph
  unless told otherwise (the JAX package's default), returns gradients
  that stop gradient unless `create_graph=True`, and raises on an input
  that does not require grad or is unused unless `allow_unused=True`.
  With `create_graph=True` a gradient stays on the tape even where torch
  found it constant in the inputs (a linear function's): it is linked to
  them with a zero derivative, as the JAX tape's backward op takes every
  primal as an input, so a second `paddle.grad` gives zeros, not
  "unused".
A row-sparse embedding gradient (`Embedding(sparse=True)`) is
accumulated beside the leaf as a `SelectedRows` (`core/tensor.py`);
inside `paddle.grad` (`sparse_densified()`) and for a leaf with hooks
the embedding's backward gives torch a dense cotangent instead, as the
JAX tape densifies one for `paddle.grad` and for hooks.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "run_backward", "grad", "sparse_densified"]

# > 0 while `paddle.grad` runs: a sparse embedding backward then hands
# torch a dense cotangent and accumulates nothing beside the leaf
_dense_depth = 0


def sparse_densified() -> bool:
    return _dense_depth > 0


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradMode:
    """A context manager that is also a decorator."""

    mode = True

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self.mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with type(self)():
                return fn(*a, **kw)

        return wrapper


class no_grad(_GradMode):
    """paddle.no_grad: nothing computed inside is recorded."""

    mode = False


class enable_grad(_GradMode):
    mode = True


class set_grad_enabled(_GradMode):
    def __init__(self, mode: bool):
        self.mode = bool(mode)

    def __call__(self, fn):
        mode = self.mode

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with set_grad_enabled(mode):
                return fn(*a, **kw)

        return wrapper


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _cotangent(t, g):
    """The seed for output `t`: ones of its shape for None (paddle fills
    ones for any shape), else `g` as a tensor of t's dtype and device."""
    from .tensor import Tensor

    if g is None:
        return torch.ones_like(t._data)
    g = g._data if isinstance(g, Tensor) else torch.as_tensor(g)
    return g.to(device=t._data.device, dtype=t._data.dtype)


def run_backward(tensors, grad_tensors=None, retain_graph=False):
    """`Tensor.backward` / `paddle.autograd.backward`: accumulate into
    the `.grad` of every leaf the outputs reach. Pending lazy outputs are
    flushed first (a `backward` barrier); the seeds whose backward that
    flush already ran in a CUDA graph are not run again."""
    from . import lazy

    tensors = _as_list(tensors)
    grads = [None] * len(tensors) if grad_tensors is None \
        else _as_list(grad_tensors)
    done = lazy.sync_backward(tensors, grads, retain_graph)
    live = [(t._data, _cotangent(t, g)) for t, g in zip(tensors, grads)
            if id(t) not in done and t._data.requires_grad]
    if live:
        torch.autograd.backward([d for d, _ in live], [g for _, g in live],
                                retain_graph=retain_graph)


class _ZeroLink(torch.autograd.Function):
    """g, unchanged, with a zero derivative in each of xs."""

    @staticmethod
    def forward(ctx, g, *xs):
        ctx.likes = [(x.shape, x.dtype, x.device) for x in xs]
        return g.view_as(g)

    @staticmethod
    def backward(ctx, dg):
        return (dg, *[torch.zeros(s, dtype=d, device=v)
                      for s, d, v in ctx.likes])


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False, no_grad_vars=None):
    """paddle.grad: gradients of `outputs` with respect to `inputs`,
    without touching any `.grad`."""
    from .tensor import Tensor

    if no_grad_vars:
        raise NotImplementedError("paddle.grad: no_grad_vars is not "
                                  "supported")
    from . import lazy

    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    # a barrier that cuts the pending region at requested intermediates
    lazy.sync_for_grad(outputs, inputs, create_graph)
    gouts = [None] * len(outputs) if grad_outputs is None \
        else _as_list(grad_outputs)
    for idx, t in enumerate(inputs):
        if not t._data.requires_grad and not allow_unused:
            raise RuntimeError(f"input {idx} does not require grad")
    live_out = [(t._data, _cotangent(t, g)) for t, g in zip(outputs, gouts)
                if t._data.requires_grad]
    slots = [i for i, t in enumerate(inputs) if t._data.requires_grad]
    found = [None] * len(inputs)
    if live_out and slots:
        global _dense_depth
        _dense_depth += 1
        try:
            gs = torch.autograd.grad(
                [d for d, _ in live_out], [inputs[i]._data for i in slots],
                grad_outputs=[g for _, g in live_out],
                retain_graph=True if retain_graph is None else retain_graph,
                create_graph=create_graph, allow_unused=True)
        finally:
            _dense_depth -= 1
        for i, g in zip(slots, gs):
            if create_graph and g is not None and not g.requires_grad:
                g = _ZeroLink.apply(g, *[inputs[j]._data for j in slots])
            found[i] = g
    results = []
    for i, g in enumerate(found):
        if g is None:
            if not allow_unused:
                raise RuntimeError(f"gradient for input {i} is unused; "
                                   "pass allow_unused=True to get None")
            results.append(None)
        else:
            results.append(Tensor._wrap(g if create_graph else g.detach()))
    return results
