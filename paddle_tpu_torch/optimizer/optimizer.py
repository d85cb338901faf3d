"""The optimizers with the JAX package's update: the port of
`paddle_tpu/optimizer/optimizer.py` for dense gradients.

The parameters are the paddle `Parameter`s of a `Layer` (eager
`Tensor`s: the update writes their `_data` in place, the state is keyed
on the `Parameter` and named by its `name`), or plain `torch` parameters
(the training model's: named by their `param_name`), given as a list or
as parameter groups (dicts with `params` and optional `learning_rate`,
`weight_decay` and `grad_clip`). A step:
  - clips the gradients (`grad_clip`, or each group's), `nn/clip.py`;
  - takes the learning rate (a float, or an `LRScheduler`'s value) in
    f32, times the group's `learning_rate` and the `Parameter`'s
    `optimize_attr["learning_rate"]` (`_lr_mult_of`, `:130-135`), the
    product rounded to f32 as the JAX step multiplies it;
  - then follows `_build_step_fn` (`:137-166`) operation by operation,
    so it rounds where the JAX step rounds: the working copy is an f32
    master for bf16/f16 parameters under `multi_precision` (`:93-95`),
    else the parameter itself; the gradient is cast to the working dtype;
    the decay (`_wd_of`, `:112-124`: the group's `weight_decay`, else the
    optimizer's, else the parameter's `regularizer`; a float or an
    `L2Decay` adds `wd * work` to the gradient, an `L1Decay`
    `wd * sign(work)`; AdamW's is decoupled, `work - (lr * wd) * work` in
    the working dtype; Lamb's enters its trust ratio) comes next, then the
    optimizer's `_update_one`.
`Adam._update_one` keeps f32 moments `b1 * m + (1 - b1) * g` and
`b2 * v + ((1 - b2) * g) * g`, beta-power accumulators, and
`work - (lr * mhat / (sqrt(vhat) + eps)).to(work.dtype)`; `SGD`,
`Momentum` (Nesterov), `Adagrad`, `Adadelta`, `RMSProp` (centered),
`Adamax`, `Lamb`, `NAdam` and `RAdam` are JAX's formulas in its order of
operations; `LBFGS` is its closure-driven two-loop recursion over the
flattened f32 gradients (the JAX package runs no line search;
`line_search_fn` is accepted and unused, as there).
`torch.optim` is not used: its AdamW decays and rounds in another order.
No Pallas kernel computes an update, so it is plain PyTorch, one
parameter at a time with in-place moments (temporaries stay at one
parameter's size). Each bias correction divides by a device tensor, not
a host scalar: CUDA divides by a host scalar as a multiply by its
reciprocal, one ulp off the JAX division.

A SelectedRows gradient (`Embedding(sparse=True)`) follows JAX's
`step` (`:200-231`): the clip runs first, on sparse and dense gradients
together; then an optimizer with `lazy_mode=False` (Adam's and AdamW's
default) densifies it, and every other one (`lazy_mode=True`, and the
optimizers without the option) updates only the touched rows
(`_sparse_apply`, `:233-302`): the duplicate rows merged in sorted-id
order, the decay and `_update_one` run on those rows of the working copy
(the f32 master rows under `multi_precision`) and of the row-shaped
accumulators, and the rows written back; untouched rows, their masters
and moments keep their bits. `LBFGS` refuses one with JAX's
`RuntimeError`.

`state_dict` holds the accumulators, the masters, `global_step` and, with
a scheduler, its state under `LR_Scheduler`.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..core.selected_rows import merge_rows
from ..core.tensor import Tensor, _to_torch
from . import lr as lr_mod

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp",
           "Adam", "AdamW", "Adamax", "Lamb", "NAdam", "RAdam", "LBFGS"]


def _param_name(p, i: int) -> str:
    """paddle's `p.name`: the model's `param_name`, else a position."""
    return getattr(p, "param_name", None) or f"param_{i}"


def _leaf(p) -> torch.Tensor:
    """The torch leaf the update writes: a Tensor's `_data`, or the torch
    parameter itself."""
    return p._data if isinstance(p, Tensor) else p


def _f32(x: float) -> float:
    """`x` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _coeff_of(weight_decay) -> float:
    """A float, or a regularizer's coefficient; None is 0."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    return float(getattr(weight_decay, "_coeff",
                         getattr(weight_decay, "coeff", 0.0)))


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar on `like`'s device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


class Optimizer:
    # subclasses list their per-parameter accumulator names
    _acc_names: List[str] = []
    # 'l1' / 'l2' fold the decay into the gradient, 'decoupled' (AdamW)
    # shrinks the working copy first, 'internal' hands it to _update_one
    # (Lamb's trust ratio)
    _wd_mode = "l2"

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            self._param_groups = []
            for g in parameters:
                g = dict(g)
                g["params"] = list(g["params"])
                self._param_groups.append(g)
            self._params = [p for g in self._param_groups
                            for p in g["params"]]
        else:
            self._params = parameters
            self._param_groups = [{"params": parameters}]
        self._group_of = {id(p): g for g in self._param_groups
                          for p in g["params"]}
        self._names = {id(p): _param_name(p, i)
                       for i, p in enumerate(self._params)
                       if not isinstance(p, Tensor)}
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {
            n: {} for n in self._acc_names}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._use_master_weights = bool(multi_precision)
        self._global_step = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _name_of(self, p) -> str:
        """A Tensor's `name` (read when asked, as the JAX package does),
        else the torch parameter's name."""
        return p.name if isinstance(p, Tensor) else self._names[id(p)]

    # -- state -------------------------------------------------------------
    def _ensure_state(self, p):
        leaf = _leaf(p)
        for name in self._acc_names:
            if id(p) not in self._accumulators[name]:
                self._accumulators[name][id(p)] = self._init_acc(name, leaf)
        if self._use_master_weights and id(p) not in self._master_weights \
                and leaf.dtype in (torch.bfloat16, torch.float16):
            self._master_weights[id(p)] = leaf.detach().float().clone()

    def _init_acc(self, name: str, p):
        if name.endswith("_pow"):   # scalar accumulators (beta powers)
            return torch.ones((), dtype=torch.float32, device=p.device)
        dt = torch.float32 if p.dtype in (torch.bfloat16, torch.float16) \
            else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def _param_decays(self, p) -> bool:
        """Subclass hook for per-parameter decay exclusion."""
        return True

    def _wd_of(self, p):
        """(coefficient, kind) of one parameter's decay, kind one of
        'l1', 'l2', 'decoupled', 'internal'."""
        group = self._group_of.get(id(p), {})
        wd = group.get("weight_decay", self._weight_decay)
        if wd is None and getattr(p, "regularizer", None) is not None:
            wd = p.regularizer
        coeff = _coeff_of(wd)
        kind = self._wd_mode
        if kind in ("l1", "l2") and type(wd).__name__ == "L1Decay":
            kind = "l1"
        if not self._param_decays(p):
            coeff = 0.0
        return coeff, kind

    def _lr_mult_of(self, p) -> float:
        mult = float(self._group_of.get(id(p), {}).get("learning_rate", 1.0))
        return mult * float(getattr(p, "optimize_attr", {}).get(
            "learning_rate", 1.0))

    def _update_one(self, work, g, accs: dict, lr: float, wd: float):
        """Returns the new working copy; updates `accs` in place."""
        raise NotImplementedError

    def _clip_grads(self, params_grads):
        group_clips = [g.get("grad_clip") for g in self._param_groups]
        if any(c is not None for c in group_clips):
            out = []
            for g in self._param_groups:
                clip = g.get("grad_clip", self._grad_clip) or self._grad_clip
                ids = {id(p) for p in g["params"]}
                sub = [(p, gr) for p, gr in params_grads if id(p) in ids]
                out.extend(clip(sub) if clip is not None else sub)
            return out
        if self._grad_clip is not None:
            return self._grad_clip(params_grads)
        return params_grads

    # -- the step ----------------------------------------------------------
    def _params_grads(self):
        """(parameter, gradient) for every parameter with a gradient: a
        Tensor, or a SelectedRows."""
        out = []
        for p in self._params:
            leaf = _leaf(p)
            if not leaf.requires_grad:
                continue
            g = p.grad if isinstance(p, Tensor) else (
                None if leaf.grad is None else Tensor._wrap(leaf.grad))
            if g is not None:
                out.append((p, g))
        return out

    @torch.no_grad()
    def step(self):
        params_grads = self._params_grads()
        if not params_grads:
            return
        params_grads = self._clip_grads(params_grads)
        if not getattr(self, "_lazy_mode", True):
            params_grads = [(p, Tensor._wrap(g.to_dense())
                             if getattr(g, "is_selected_rows", False) else g)
                            for p, g in params_grads]
        sparse = [(p, g) for p, g in params_grads
                  if getattr(g, "is_selected_rows", False)]
        self._global_step += 1
        lr = _f32(self.get_lr())
        for p, g in params_grads:
            if g is None or getattr(g, "is_selected_rows", False):
                continue
            self._step_one(p, g._data if isinstance(g, Tensor) else g,
                           self._plr(p, lr))
        for p, sr in sparse:
            self._sparse_apply(p, sr, self._plr(p, lr))

    def _plr(self, p, lr):
        mult = self._lr_mult_of(p)
        return lr if mult == 1.0 else _f32(np.float32(lr) * np.float32(mult))

    def _decayed(self, p, work, g, lr):
        """(working copy, gradient in its dtype) after the decay, and the
        coefficient."""
        gg = g.to(work.dtype)
        wd, kind = self._wd_of(p)
        if wd and kind == "l2":
            gg = gg + wd * work
        elif wd and kind == "l1":
            gg = gg + wd * torch.sign(work)
        elif wd and kind == "decoupled":
            # JAX: lr (f32) cast to the working dtype, times wd (a Python
            # float, so taken in that dtype), then times the working copy
            c = (torch.tensor(lr, dtype=torch.float32).to(work.dtype).float()
                 * torch.tensor(wd, dtype=torch.float64).to(work.dtype)
                 .float()).to(work.dtype)
            work = work - work * float(c)
        return work, gg, wd

    def _step_one(self, p, g, lr):
        self._ensure_state(p)
        leaf = _leaf(p)
        master = self._master_weights.get(id(p))
        work = master if master is not None else leaf.detach()
        work, gg, wd = self._decayed(p, work, g, lr)
        accs = {k: self._accumulators[k][id(p)] for k in self._acc_names}
        new_work = self._update_one(work, gg, accs, lr, wd)
        if master is not None:
            master.copy_(new_work)
            leaf.copy_(new_work.to(leaf.dtype))
        else:
            leaf.copy_(new_work)

    def _sparse_apply(self, p, sr, lr):
        """The lazy update from a SelectedRows: only the merged rows of the
        working copy and of the row-shaped accumulators change (scalar
        accumulators, the beta powers, step as in the dense update)."""
        self._ensure_state(p)
        leaf = _leaf(p)
        u_rows, merged = merge_rows(sr.rows, sr.values, sr.height)
        idx = u_rows.long()
        master = self._master_weights.get(id(p))
        src = master if master is not None else leaf.detach()
        work, gg, wd = self._decayed(p, src[idx], merged, lr)
        full = {k: self._accumulators[k][id(p)] for k in self._acc_names}
        rowwise = {k: tuple(a.shape[:1]) == tuple(leaf.shape[:1])
                   and a.dim() > 0 for k, a in full.items()}
        accs = {k: a[idx] if rowwise[k] else a for k, a in full.items()}
        new_work = self._update_one(work, gg, accs, lr, wd)
        for k, a in full.items():
            if rowwise[k]:
                a.index_copy_(0, idx, accs[k].to(a.dtype))
        if master is not None:
            master.index_copy_(0, idx, new_work.to(master.dtype))
        leaf.index_copy_(0, idx, new_work.to(leaf.dtype))

    def clear_grad(self, set_to_zero=False):
        for p in self._params:
            if isinstance(p, Tensor):
                p.clear_gradient(set_to_zero)
            elif p.grad is not None:
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """`loss.backward()`, then `step()`."""
        loss.backward()
        self.step()
        return None, None

    def state_dict(self) -> dict:
        """`{name}_{accumulator}` and `{name}_master` tensors, and
        `global_step`, under paddle's names (`name` / `param_name`):
        `Tensor`s for a Layer's parameters, as the JAX package gives
        them, torch tensors for torch parameters; and the scheduler's
        state under `LR_Scheduler`."""
        params = {id(p): p for p in self._params}
        sd = {}

        def put(key, pid, t):
            p = params[pid]
            sd[f"{self._name_of(p)}_{key}"] = Tensor._wrap(t) \
                if isinstance(p, Tensor) else t
        for acc, by_param in self._accumulators.items():
            for pid, t in by_param.items():
                put(acc, pid, t)
        for pid, t in self._master_weights.items():
            put("master", pid, t)
        sd["global_step"] = self._global_step
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict):
        """Copy each accumulator and master weight (a Tensor of either
        package's `paddle.load`, a torch tensor or a numpy array) onto
        its parameter's device, and the scheduler's state."""
        by_name = {self._name_of(p): p for p in self._params}
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, lr_mod.LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for key, val in state_dict.items():
            if key in ("global_step", "LR_Scheduler"):
                continue
            for acc in self._acc_names + ["master"]:
                if not key.endswith(f"_{acc}"):
                    continue
                p = by_name.get(key[:-len(acc) - 1])
                if p is not None:
                    t = val._data if isinstance(val, Tensor) else val \
                        if isinstance(val, torch.Tensor) \
                        else _to_torch(val, "cpu")
                    t = t.detach().to(_leaf(p).device).clone()
                    if acc == "master":
                        self._master_weights[id(p)] = t
                    else:
                        self._accumulators[acc][id(p)] = t
                break

    set_dict = set_state_dict


class SGD(Optimizer):
    _acc_names: List[str] = []

    def _update_one(self, work, g, accs, lr, wd):
        lr_t = torch.tensor(lr, dtype=torch.float32).to(work.dtype)
        return work - lr_t * g


class Momentum(Optimizer):
    """Heavy-ball momentum, or Nesterov's with `use_nesterov`; the
    velocity is f32 for 16-bit parameters."""

    _acc_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _update_one(self, work, g, accs, lr, wd):
        v = accs["velocity"]
        gv = g.to(v.dtype)
        v.mul_(self._momentum).add_(gv)
        upd = gv + self._momentum * v if self._nesterov else v
        return work - (_scalar(lr, v) * upd).to(work.dtype)


class Adagrad(Optimizer):
    """`m + g * g` (f32, from `initial_accumulator_value`), and
    `work - lr * g / (sqrt(m) + eps)` in the working dtype."""

    _acc_names = ["moment"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._epsilon = float(epsilon)
        self._init_value = float(initial_accumulator_value)

    def _init_acc(self, name, p):
        return torch.full(p.shape, self._init_value, dtype=torch.float32,
                          device=p.device)

    def _update_one(self, work, g, accs, lr, wd):
        m = accs["moment"]
        m.add_((g * g).to(m.dtype))
        upd = g / (torch.sqrt(m).to(work.dtype) + self._epsilon)
        return work - _scalar(lr, work).to(work.dtype) * upd


class Adadelta(Optimizer):
    _acc_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._epsilon = float(epsilon)
        self._rho = float(rho)

    def _update_one(self, work, g, accs, lr, wd):
        gf = g.float()
        rho, eps = self._rho, self._epsilon
        sq, su = accs["avg_squared_grad"], accs["avg_squared_update"]
        sq.copy_(rho * sq + (1 - rho) * gf * gf)
        upd = -torch.sqrt((su + eps) / (sq + eps)) * gf
        su.copy_(rho * su + (1 - rho) * upd * upd)
        return work + _scalar(lr, work).to(work.dtype) * upd.to(work.dtype)


class RMSProp(Optimizer):
    _acc_names = ["mean_square", "mean_grad", "momentum_acc"]

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)

    def _update_one(self, work, g, accs, lr, wd):
        gf = g.float()
        rho, eps = self._rho, self._epsilon
        ms, mg, mom = (accs["mean_square"], accs["mean_grad"],
                       accs["momentum_acc"])
        ms.copy_(rho * ms + (1 - rho) * gf * gf)
        if self._centered:
            mg.copy_(rho * mg + (1 - rho) * gf)
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom.copy_(self._momentum * mom + _scalar(lr, gf) * gf / denom)
        return work - mom.to(work.dtype)


class Adam(Optimizer):
    _acc_names = ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._beta1 = float(beta1.item() if isinstance(beta1, Tensor)
                            else beta1)
        self._beta2 = float(beta2.item() if isinstance(beta2, Tensor)
                            else beta2)
        self._epsilon = float(epsilon)
        self._lazy_mode = bool(lazy_mode)

    def _moments(self, g, accs):
        """The f32 moment and beta-power updates, in place; returns
        (gf, m, v, b1p, b2p)."""
        gf = g.float()
        b1, b2 = self._beta1, self._beta2
        m, v = accs["moment1"], accs["moment2"]
        t = gf * (1 - b1)
        m.mul_(b1).add_(t)
        t = gf * (1 - b2)
        t.mul_(gf)
        v.mul_(b2).add_(t)
        b1p, b2p = accs["beta1_pow"], accs["beta2_pow"]
        b1p.mul_(b1)
        b2p.mul_(b2)
        return gf, m, v, b1p, b2p

    def _update_one(self, work, g, accs, lr, wd):
        _, m, v, b1p, b2p = self._moments(g, accs)
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        upd = (mhat * lr) / (vhat.sqrt_() + self._epsilon)
        return work - upd.to(work.dtype)


class AdamW(Adam):
    """Adam with decoupled weight decay (paddle's `AdamW`);
    `apply_decay_param_fun(name)` picks the parameters that decay."""

    _wd_mode = "decoupled"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _param_decays(self, p):
        if self._apply_decay_param_fun is None:
            return True
        return bool(self._apply_decay_param_fun(self._name_of(p)))


class Adamax(Optimizer):
    _acc_names = ["moment", "inf_norm", "beta1_pow"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _update_one(self, work, g, accs, lr, wd):
        gf = g.float()
        m, u, b1p = accs["moment"], accs["inf_norm"], accs["beta1_pow"]
        m.copy_(self._beta1 * m + (1 - self._beta1) * gf)
        u.copy_(torch.maximum(self._beta2 * u, torch.abs(gf)))
        b1p.mul_(self._beta1)
        upd = _scalar(lr, gf) / (1 - b1p) * m / (u + self._epsilon)
        return work - upd.to(work.dtype)


class Lamb(Optimizer):
    """Adam's moments with the decay inside the update and a layer-wise
    trust ratio `|w| / |r|`; `exclude_from_weight_decay_fn(param)` turns
    the decay off for a parameter."""

    _acc_names = ["moment1", "moment2", "beta1_pow", "beta2_pow"]
    _wd_mode = "internal"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, multi_precision=multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _param_decays(self, p):
        if self._exclude_fn is None:
            return True
        return not bool(self._exclude_fn(p))

    def _update_one(self, work, g, accs, lr, wd):
        gf = g.float()
        b1, b2 = self._beta1, self._beta2
        m, v = accs["moment1"], accs["moment2"]
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        b1p, b2p = accs["beta1_pow"], accs["beta2_pow"]
        b1p.mul_(b1)
        b2p.mul_(b2)
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        wf = work.float()
        r = mhat / (torch.sqrt(vhat) + self._epsilon) + wd * wf
        w_norm = torch.sqrt((wf * wf).sum())
        r_norm = torch.sqrt((r * r).sum())
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), dtype=torch.float32,
                                       device=wf.device))
        return work - (_scalar(lr, wf) * trust * r).to(work.dtype)


class NAdam(Adam):
    """Adam with Nesterov momentum:
    `mhat = b1 m / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)`."""

    def _update_one(self, work, g, accs, lr, wd):
        gf, m, v, b1p, b2p = self._moments(g, accs)
        b1 = self._beta1
        mhat = b1 * m / (1 - b1p * b1) + (1 - b1) * gf / (1 - b1p)
        vhat = v / (1 - b2p)
        upd = _scalar(lr, gf) * mhat / (torch.sqrt(vhat) + self._epsilon)
        return work - upd.to(work.dtype)


class RAdam(Adam):
    """Rectified Adam: the adaptive step where the variance's length
    `rho_t` exceeds 4, else the momentum step; t is recovered from
    `beta2^t`."""

    def _update_one(self, work, g, accs, lr, wd):
        _, m, v, b1p, b2p = self._moments(g, accs)
        b2 = self._beta2
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        # jnp.log of the Python beta2 is taken in f64 (x64), then f32
        t_like = torch.log(b2p) / _scalar(math.log(b2), b2p)
        rho_t = rho_inf - 2.0 * t_like * b2p / (1 - b2p)
        mhat = m / (1 - b1p)
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf) / torch.clamp(
            (rho_inf - 4) * (rho_inf - 2) * rho_t, min=1e-8))
        vhat = torch.sqrt(v / (1 - b2p))
        lr_t = _scalar(lr, m)
        upd = torch.where(rho_t > 4.0,
                          lr_t * r * mhat / (vhat + self._epsilon),
                          lr_t * mhat)
        return work - upd.to(work.dtype)


class LBFGS(Optimizer):
    """L-BFGS over the flattened f32 gradients, driven by a closure that
    returns the loss (with its gradients computed): the two-loop
    recursion over the last `history_size` (s, y) pairs with a positive
    curvature, scaled by `s.y / y.y`, and a step of `lr` along it."""

    _acc_names: List[str] = []

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._max_iter = max_iter
        self._history_size = history_size
        self._s, self._y = [], []
        self._prev_flat_grad = None
        self._prev_flat_params = None

    @staticmethod
    def _flat(arrs):
        return torch.cat([a.reshape(-1).float() for a in arrs])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure returning the "
                             "loss")
        with torch.enable_grad():
            loss = closure()
        pairs = self._params_grads()
        if any(getattr(g, "is_selected_rows", False) for _, g in pairs):
            raise RuntimeError(
                "LBFGS keeps dense curvature history and does not support "
                "SelectedRows gradients; use Embedding(sparse=False) or a "
                "first-order optimizer (SGD/Adam lazy_mode)")
        leaves = [_leaf(p) for p, _ in pairs]
        flat_grad = self._flat([g._data for _, g in pairs])
        if self._prev_flat_grad is not None:
            flat_params = self._flat(leaves)
            if self._prev_flat_params is None:
                self._prev_flat_params = flat_params
            s = flat_params - self._prev_flat_params
            y = flat_grad - self._prev_flat_grad
            if float((y * s).sum()) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self._history_size:
                    self._s.pop(0)
                    self._y.pop(0)
        q = flat_grad
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / float((y * s).sum())
            alpha = rho * float((s * q).sum())
            alphas.append((alpha, rho))
            q = q - alpha * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (float((s * y).sum()) / float((y * y).sum()))
        for (alpha, rho), s, y in zip(reversed(alphas), self._s, self._y):
            beta = rho * float((y * q).sum())
            q = q + (alpha - beta) * s
        direction = -q
        lr = self.get_lr()
        self._prev_flat_grad = flat_grad
        self._prev_flat_params = self._flat(leaves)
        offset = 0
        for leaf in leaves:
            n = leaf.numel()
            upd = direction[offset:offset + n].reshape(leaf.shape)
            leaf.copy_(leaf + lr * upd.to(leaf.dtype))
            offset += n
        return loss
