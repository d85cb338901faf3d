"""User-defined autograd functions: the port of
`paddle_tpu/autograd/py_layer.py` over `torch.autograd.Function`.

A `PyLayer` subclass defines static `forward(ctx, *args, **kwargs)` and
`backward(ctx, *grads)` over Tensors. `apply` runs the forward without
recording, splices the pair into torch's graph as one node whose inputs
are the Tensor arguments, and returns the forward's own Tensor objects,
now carrying that node. The backward gets one gradient per Tensor
output (zeros for an unused one while `materialize_grads` holds) and
returns one per Tensor input (None for no gradient); another count
raises `RuntimeError`.
"""
from __future__ import annotations

from typing import List

import torch

from ..core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    def __init__(self):
        self._saved: List[Tensor] = []
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return list(self._saved)

    def mark_not_inplace(self, *a):
        pass

    def mark_non_differentiable(self, *a):
        pass

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)


class _Spliced(torch.autograd.Function):
    """forward(ctx, layer, pctx, kwargs, box, *args): `args` are the
    PyLayer's positional arguments with each Tensor as its torch tensor.
    The forward's own result goes into `box`; the torch tensors of its
    Tensor outputs are returned, so they carry this node."""

    @staticmethod
    def forward(ctx, layer, pctx, kwargs, box, *args):
        wrapped = [Tensor._wrap(a) if isinstance(a, torch.Tensor) else a
                   for a in args]
        outputs = layer.forward(pctx, *wrapped, **kwargs)
        box.append(outputs)
        outs = list(outputs) if isinstance(outputs, (tuple, list)) \
            else [outputs]
        ctx.layer, ctx.pctx = layer, pctx
        ctx.slots = [i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor)]
        ctx.n_args = len(args)
        ctx.set_materialize_grads(pctx.materialize_grads)
        return tuple(o._data for o in outs if isinstance(o, Tensor))

    @staticmethod
    def backward(ctx, *grads):
        gs = [None if g is None else Tensor._wrap(g) for g in grads]
        with torch.no_grad():
            res = ctx.layer.backward(ctx.pctx, *gs)
        if not isinstance(res, (tuple, list)):
            res = (res,)
        if len(res) != len(ctx.slots):
            raise RuntimeError(
                f"PyLayer.backward returned {len(res)} gradients for "
                f"{len(ctx.slots)} tensor inputs")
        out = [None] * ctx.n_args
        for slot, g in zip(ctx.slots, res):
            out[slot] = g._data if isinstance(g, Tensor) else (
                None if g is None else torch.as_tensor(g))
        return (None, None, None, None, *out)


class PyLayer:
    """Subclass with static `forward(ctx, *args)` / `backward(ctx,
    *grads)` and call `apply` (`paddle.autograd.PyLayer`)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        box = []
        spliced = _Spliced.apply(
            cls, PyLayerContext(), kwargs, box,
            *[a._data if isinstance(a, Tensor) else a for a in args])
        outputs = box[0]
        # the forward's own Tensor objects take the spliced tensors
        it = iter((spliced,) if isinstance(spliced, torch.Tensor)
                  else spliced)
        for o in (outputs if isinstance(outputs, (tuple, list))
                  else [outputs]):
            if isinstance(o, Tensor):
                o._data = next(it)
                o._grad_wrap = None
        return outputs
