"""paddle.autograd for the port: the grad-mode switches, `grad` and
`backward` over torch autograd (`core/autograd.py`), `PyLayer` and the
functional `jacobian` / `hessian` / `vjp` / `jvp`."""
from ..core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                             run_backward, set_grad_enabled)
from .functional import hessian, jacobian, jvp, vjp
from .py_layer import PyLayer, PyLayerContext


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward"""
    return run_backward(tensors, grad_tensors, retain_graph)


__all__ = ["PyLayer", "PyLayerContext", "no_grad", "enable_grad",
           "is_grad_enabled", "set_grad_enabled", "grad", "backward",
           "jacobian", "hessian", "vjp", "jvp"]
