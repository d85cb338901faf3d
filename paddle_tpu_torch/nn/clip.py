"""Gradient clipping: the port of `paddle_tpu/nn/clip.py`.

A clip takes `(param, grad)` pairs (grads are `Tensor`s, or the torch
gradients of a torch model) and returns new pairs; a parameter whose
`need_clip` is False, and a missing gradient, pass through. The
computation is JAX's, on each gradient's own device, with no host read:
- `ClipGradByValue(max, min=-max)`: `minimum(maximum(g, min), max)`;
- `ClipGradByNorm(c)`: each gradient by its own f32 norm,
  `g * min(c / max(norm, 1e-12), 1)` with the scale cast to g's dtype;
- `ClipGradByGlobalNorm(c)`: one f32 norm over every gradient (the sum
  of each gradient's f32 sum of squares, in order), and each gradient
  times `c / max(norm, c)` cast to its dtype.
`clip_grad_norm_` / `clip_grad_value_` rescale the gradients of a list of
parameters in place (torch's names, paddle's `nn.utils`).

A SelectedRows gradient (row-sparse, from `Embedding(sparse=True)`)
takes JAX's sparse branch of each clip: `ClipGradByValue` clips the
MERGED rows (JAX's padded layout), `ClipGradByNorm` scales the values by
the merged rows' norm, and `ClipGradByGlobalNorm` adds the merged rows'
square sum after the dense gradients' before scaling every gradient.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.tensor import Tensor

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _sparse(g) -> bool:
    return getattr(g, "is_selected_rows", False)


def _dense(g):
    """A dense gradient's torch data."""
    return g._data if isinstance(g, Tensor) else g


def _like(g, data):
    return Tensor._wrap(data) if isinstance(g, Tensor) else data


def _skips(p, g) -> bool:
    return g is None or not getattr(p, "need_clip", True)


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    gf = g.float()
    return torch.sum(gf * gf)


class ClipGradBase:
    def __call__(self, params_grads: List[Tuple[Tensor, Tensor]]):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skips(p, g):
                out.append((p, g))
                continue
            if _sparse(g):
                m = g.merged()      # the clip applies to the MERGED rows
                m.values = self._clip(m.values)
                out.append((p, m))
                continue
            out.append((p, _like(g, self._clip(_dense(g)))))
        return out

    def _clip(self, d):
        lo = torch.full((), self.min, dtype=d.dtype, device=d.device)
        hi = torch.full((), self.max, dtype=d.dtype, device=d.device)
        return torch.minimum(torch.maximum(d, lo), hi)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skips(p, g):
                out.append((p, g))
                continue
            sq = g.sq_sum() if _sparse(g) else _sq_sum(_dense(g))
            norm = torch.sqrt(sq)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads) -> torch.Tensor:
        """The f32 norm of the gradients (torch data or SelectedRows): the
        dense square sums in order, then the sparse ones (merged rows)."""
        total = 0
        for d in grads:
            if not _sparse(d):
                total = total + _sq_sum(d)
        sparse = 0
        for d in grads:
            if _sparse(d):
                sparse = sparse + d.sq_sum()
        return torch.sqrt(total + sparse)

    def __call__(self, params_grads):
        active = [(p, g) for p, g in params_grads if not _skips(p, g)]
        if not active:
            return params_grads
        norm = self.global_norm([g if _sparse(g) else _dense(g)
                                 for _, g in active])
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        out = []
        for p, g in params_grads:
            if _skips(p, g):
                out.append((p, g))
                continue
            out.append((p, _scaled(g, scale)))
        return out


def _scaled(g, scale):
    """g times an f32 scalar cast to g's dtype."""
    if _sparse(g):
        return g.scaled(scale)
    d = _dense(g)
    return _like(g, d * scale.to(d.dtype))


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place so that their joint
    `norm_type` norm is at most `max_norm` (coefficient
    `min(max_norm / (total + 1e-6), 1)`); returns the norm before."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    sparse = [g.merged_static()[1] for g in grads if _sparse(g)]
    dense = [_dense(g) for g in grads if not _sparse(g)]
    if not grads:
        return Tensor._wrap(torch.tensor(0.0))
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.abs(g).max()
                                       for g in dense + sparse]))
    else:
        total = (sum(torch.sum(torch.abs(g.float()) ** norm_type)
                     for g in dense)
                 + sum(torch.sum(torch.abs(g.float()) ** norm_type)
                       for g in sparse)) ** (1.0 / norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    with torch.no_grad():
        for p in parameters:
            g = p.grad
            if g is None:
                continue
            if _sparse(g):
                p.grad = g.scaled(coef)
            else:
                p.grad = Tensor._wrap(g._data * coef.to(g._data.dtype))
    return Tensor._wrap(total)


def clip_grad_value_(parameters, clip_value):
    """Clip each parameter's gradient to [-clip_value, clip_value]."""
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad = p.grad.clip(-clip_value, clip_value)
