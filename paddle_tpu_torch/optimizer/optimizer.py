"""`Optimizer`, `SGD`, `Momentum`, `Adam` and `AdamW` with the JAX
package's update.

The port of `paddle_tpu/optimizer/optimizer.py:39-231`, `:304-334`,
`:343-382` and `:491-542` for dense gradients. The parameters are the
paddle `Parameter`s of a `Layer` (eager `Tensor`s: the update writes
their `_data` in place, the state is keyed on the `Parameter` and named
by its `name`), or plain `torch` parameters (the training model's: named
by their `param_name`). The update follows `_build_step_fn`
(`:137-166`) operation by operation, so a step rounds where the JAX step
rounds:
  - the working copy is an f32 master for bf16/f16 parameters under
    `multi_precision` (`:93-95`), else the parameter itself;
  - the gradient is cast to the working dtype; L2 decay is added to it
    (Adam), or (AdamW) the decoupled decay comes first,
    `work - (lr * wd) * work` in the working dtype;
  - `Adam._update_one`: f32 moments `b1 * m + (1 - b1) * g` and
    `b2 * v + ((1 - b2) * g) * g`, beta-power accumulators, and
    `work - (lr * mhat / (sqrt(vhat) + eps)).to(work.dtype)`;
  - `SGD`: `work - lr.to(work.dtype) * g`; `Momentum`: velocity
    `mu * v + g` (f32 for 16-bit parameters), Nesterov's `g + mu * v`,
    and `work - (lr * update).to(work.dtype)`.
The learning rate enters as an f32 value, as JAX's device scalar does,
times a `Parameter`'s `optimize_attr["learning_rate"]`.
`torch.optim` is not used: its AdamW decays and rounds in another order.
No Pallas kernel computes the update, so it is plain PyTorch, one
parameter at a time with in-place moments (temporaries stay at one
parameter's size). Each bias correction divides by a device tensor, not a
host scalar: CUDA divides by a host scalar as a multiply by its
reciprocal, one ulp off the JAX division.

Not ported yet (Queue A item 7): LR schedulers, gradient clipping,
regularizer objects (`weight_decay` is a float), parameter groups,
SelectedRows gradients and the other optimizers.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.tensor import Tensor, _to_torch

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


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


class Optimizer:
    # subclasses list their per-parameter accumulator names
    _acc_names: List[str] = []
    # 'l2' folds decay into the gradient; 'decoupled' (AdamW) shrinks the
    # working copy first
    _wd_mode = "l2"

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            raise NotImplementedError("parameter groups are not ported yet")
        if grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("LR schedulers are not ported yet: "
                                      "pass a float learning rate")
        self._params = parameters
        self._names = {id(p): _param_name(p, i)
                       for i, p in enumerate(parameters)
                       if not isinstance(p, Tensor)}
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {
            n: {} for n in self._acc_names}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._use_master_weights = bool(multi_precision)
        self._global_step = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float):
        self._learning_rate = float(value)

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

    @staticmethod
    def _init_acc(name: str, p):
        if name.endswith("_pow"):   # scalar accumulators (beta powers)
            return torch.ones((), dtype=torch.float32, device=p.device)
        dt = torch.float32 if p.dtype in (torch.bfloat16, torch.float16) \
            else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    def _param_decays(self, p) -> bool:
        """Subclass hook for per-parameter decay exclusion."""
        return True

    def _update_one(self, work, g, accs: dict, lr: float):
        """Returns the new working copy; updates `accs` in place."""
        raise NotImplementedError

    def _lr_of(self, p, lr: float) -> float:
        """The f32 learning rate times a Parameter's `optimize_attr`
        multiplier, rounded to f32 as the JAX step multiplies it."""
        mult = float(getattr(p, "optimize_attr", {}).get("learning_rate",
                                                         1.0))
        return lr if mult == 1.0 else _f32(np.float32(lr) * np.float32(mult))

    # -- the step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        pairs = [(p, _leaf(p).grad) for p in self._params
                 if _leaf(p).requires_grad and _leaf(p).grad is not None]
        if not pairs:
            return
        self._global_step += 1
        lr = _f32(self.get_lr())
        for p, g in pairs:
            self._step_one(p, g, self._lr_of(p, lr))

    def _step_one(self, p, g, lr):
        self._ensure_state(p)
        leaf = _leaf(p)
        master = self._master_weights.get(id(p))
        work = master if master is not None else leaf.detach()
        gg = g.to(work.dtype)
        wd = self._weight_decay if self._param_decays(p) else 0.0
        if wd and self._wd_mode == "l2":
            gg = gg + wd * work
        elif wd:
            # JAX: lr (f32) cast to the working dtype, times wd (a Python
            # float, so taken in that dtype), then times the working copy
            c = (torch.tensor(lr, dtype=torch.float32).to(work.dtype).float()
                 * torch.tensor(wd, dtype=torch.float64).to(work.dtype)
                 .float()).to(work.dtype)
            work = work - work * float(c)
        accs = {k: self._accumulators[k][id(p)] for k in self._acc_names}
        new_work = self._update_one(work, gg, accs, lr)
        if master is not None:
            master.copy_(new_work)
            leaf.copy_(new_work.to(leaf.dtype))
        else:
            leaf.copy_(new_work)

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
        them, torch tensors for torch parameters."""
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
        return sd

    def set_state_dict(self, state_dict: dict):
        """Copy each accumulator and master weight (a Tensor of either
        package's `paddle.load`, a torch tensor or a numpy array) onto
        its parameter's device."""
        by_name = {self._name_of(p): p for p in self._params}
        self._global_step = int(state_dict.get("global_step", 0))
        for key, val in state_dict.items():
            if key == "global_step":
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

    def _update_one(self, work, g, accs, lr):
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

    def _update_one(self, work, g, accs, lr):
        v = accs["velocity"]
        gv = g.to(v.dtype)
        v.mul_(self._momentum).add_(gv)
        upd = gv + self._momentum * v if self._nesterov else v
        return work - (torch.tensor(lr, dtype=torch.float32,
                                    device=v.device) * upd).to(work.dtype)


class Adam(Optimizer):
    _acc_names = ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _update_one(self, work, g, accs, lr):
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
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        upd = (mhat * lr) / (vhat.sqrt_() + self._epsilon)
        return work - upd.to(work.dtype)


class AdamW(Adam):
    """Adam with decoupled weight decay (paddle's `AdamW`)."""

    _wd_mode = "decoupled"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _param_decays(self, p):
        if self._apply_decay_param_fun is None:
            return True
        return bool(self._apply_decay_param_fun(self._name_of(p)))
