"""Functional higher-order AD (the port of
`paddle_tpu/autograd/functional.py`): `jacobian`, `hessian`, `vjp` and
`jvp`, built on `paddle.grad` with `create_graph=True` as the JAX
package builds them on its tape. `jvp` is the transpose of a vjp (the
double-vjp construction). `batch_axis` raises `NotImplementedError`, as
in JAX."""
from __future__ import annotations

import torch

from ..core.autograd import grad as _grad
from ..core.tensor import Tensor

__all__ = ["jacobian", "hessian", "vjp", "jvp"]


def _rows(y):
    """The scalar components of y, each still on the tape."""
    flat = y.reshape([max(y.size, 1)])
    for i in range(flat.shape[0]):
        yield flat[i]


def jacobian(ys, xs, batch_axis=None):
    """J[i, j] = d ys_i / d xs_j, row by row with `create_graph`, so the
    result is itself differentiable."""
    from ..ops.manipulation import stack

    if batch_axis is not None:
        raise NotImplementedError(
            "batch_axis (per-sample batched jacobian) is not implemented")
    single_x = not isinstance(xs, (list, tuple))
    xs_l = [xs] if single_x else list(xs)
    rows = []
    for yi in _rows(ys):
        gs = _grad(yi, xs_l, create_graph=True, allow_unused=True)
        rows.append([(Tensor._wrap(torch.zeros_like(x._data.detach()))
                      if g is None else g).reshape([-1])
                     for x, g in zip(xs_l, gs)])
    jacs = [stack([r[j] for r in rows], axis=0) for j in range(len(xs_l))]
    return jacs[0] if single_x else jacs


def hessian(ys, xs, batch_axis=None):
    """The full block Hessian of a scalar: H[i][j] = d^2 ys / d xs_i d
    xs_j, cross blocks included."""
    if batch_axis is not None:
        raise NotImplementedError(
            "batch_axis (per-sample batched hessian) is not implemented")
    if tuple(ys.shape) not in ((), (1,)):
        raise ValueError("hessian expects a scalar output")
    single_x = not isinstance(xs, (list, tuple))
    xs_l = [xs] if single_x else list(xs)
    gs = _grad(ys, xs_l, create_graph=True, allow_unused=False)
    hs = [[jacobian(g, x) for x in xs_l] for g in gs]
    return hs[0][0] if single_x else hs


def _requiring(xs_l):
    """Make xs require grad for the call; returns their old flags."""
    prev = [x.stop_gradient for x in xs_l]
    for x in xs_l:
        x.stop_gradient = False
    return prev


def vjp(func, xs, v=None):
    """(outputs, v^T J)."""
    single_x = not isinstance(xs, (list, tuple))
    xs_l = [xs] if single_x else list(xs)
    prev = _requiring(xs_l)
    try:
        ys = func(*xs_l)
        ys_l = ys if isinstance(ys, (list, tuple)) else [ys]
        gouts = [None] * len(ys_l) if v is None else list(
            v if isinstance(v, (list, tuple)) else [v])
        gs = _grad(list(ys_l), xs_l, grad_outputs=gouts, create_graph=True,
                   allow_unused=True)
    finally:
        for x, sg in zip(xs_l, prev):
            x.stop_gradient = sg
    return ys, (gs[0] if single_x else gs)


def jvp(func, xs, v=None):
    """(outputs, J v) by double vjp: with u a dummy cotangent that
    requires grad, d(u . dy/dx . v)/du = J v."""
    single_x = not isinstance(xs, (list, tuple))
    xs_l = [xs] if single_x else list(xs)
    prev = _requiring(xs_l)
    try:
        ys = func(*xs_l)
        ys_l = ys if isinstance(ys, (list, tuple)) else [ys]
        us = [Tensor(torch.ones_like(y._data.detach()), stop_gradient=False)
              for y in ys_l]
        gs = _grad(list(ys_l), xs_l, grad_outputs=us, create_graph=True,
                   allow_unused=True)
    finally:
        for x, sg in zip(xs_l, prev):
            x.stop_gradient = sg
    v_l = [Tensor._wrap(torch.ones_like(x._data.detach())) for x in xs_l] \
        if v is None else list(v if isinstance(v, (list, tuple)) else [v])
    total = None
    for g, vv in zip(gs, v_l):
        if g is not None:
            term = (g * vv).sum()
            total = term if total is None else total + term
    if total is None:
        res = [Tensor._wrap(torch.zeros_like(y._data.detach()))
               for y in ys_l]
    else:
        outs = _grad(total, us, create_graph=False, allow_unused=True)
        res = [o if o is not None else
               Tensor._wrap(torch.zeros_like(y._data.detach()))
               for o, y in zip(outs, ys_l)]
    if not isinstance(ys, (list, tuple)):
        return ys, res[0]
    return ys, res
