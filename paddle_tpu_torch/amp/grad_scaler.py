"""Dynamic loss scaling: the port of `paddle_tpu/amp/grad_scaler.py`
(`GradScaler` / `AmpScaler`).

The unscale and the found-inf check run on the device over every
gradient (`grad * (1 / scale)` in the gradient's dtype, then one
all-finite reduction); only the final flag crosses to the host, once a
step, to decide whether the optimizer steps or the step is skipped. A
SelectedRows gradient (`Embedding(sparse=True)`) has its values
unscaled, and their finite flag joins the dense ones in that one read.
"""
from __future__ import annotations

import enum
from typing import Dict

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["GradScaler", "AmpScaler", "OptimizerState"]


class OptimizerState(enum.Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


def _grad_of(p):
    """The torch gradient of a Tensor or a torch parameter."""
    d = p._data if isinstance(p, Tensor) else p
    return d.grad


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._init_loss_scaling = float(init_loss_scaling)
        self._loss_scaling = float(init_loss_scaling)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._use_dynamic_loss_scaling = bool(use_dynamic_loss_scaling)
        self._incr_count = 0
        self._decr_count = 0
        self._found_inf = False
        self._skipped_steps = 0      # found-inf skips over the run
        self._last_skipped = False   # did the most recent step() skip?
        self._opt_states: Dict[int, OptimizerState] = {}

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic_loss_scaling

    # -- forward side -------------------------------------------------------
    def scale(self, var: Tensor) -> Tensor:
        if not self._enable:
            return var
        return var * self._loss_scaling

    # -- backward side ------------------------------------------------------
    def _unscale(self, optimizer):
        if not self._enable:
            return
        if self._opt_states.get(id(optimizer)) == OptimizerState.UNSCALED:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        finite = []
        with torch.no_grad():
            for p in optimizer._params:
                sr = p._sr if isinstance(p, Tensor) else None
                if sr is None:
                    continue
                inv = torch.tensor(1.0 / self._loss_scaling,
                                   dtype=torch.float32)
                # beside a dense part of the same gradient, which the
                # loop below unscales
                p._sr = sr = sr.scaled(inv)
                finite.append(torch.isfinite(sr.values).all())
            grads = [g for g in (_grad_of(p) for p in optimizer._params)
                     if g is not None]
            if grads:
                inv = torch.tensor(1.0 / self._loss_scaling,
                                   dtype=torch.float32,
                                   device=grads[0].device)
            for g in grads:
                g.mul_(inv.to(g.dtype))
                finite.append(torch.isfinite(g).all())
        found = False
        if finite:
            # the one host read of the step
            found = not bool(torch.stack(
                [f.to(finite[0].device) for f in finite]).all())
        self._found_inf = found
        self._opt_states[id(optimizer)] = OptimizerState.UNSCALED

    unscale_ = _unscale

    def _update(self):
        if not (self._enable and self._use_dynamic_loss_scaling):
            return
        if self._found_inf:
            self._incr_count = 0
            self._decr_count += 1
            if self._decr_count >= self._decr_every_n_nan_or_inf:
                self._loss_scaling = max(
                    self._loss_scaling * self._decr_ratio, 1.0)
                self._decr_count = 0
        else:
            self._decr_count = 0
            self._incr_count += 1
            if self._incr_count >= self._incr_every_n_steps:
                self._loss_scaling *= self._incr_ratio
                self._incr_count = 0

    def _note_skip(self):
        """Record whether the step just decided was a found-inf skip."""
        self._last_skipped = bool(self._found_inf)
        if self._found_inf:
            self._skipped_steps += 1
            from ..framework import monitor

            monitor.inc("amp.skipped_steps")

    def last_step_skipped(self) -> bool:
        return self._last_skipped

    def get_skipped_steps(self) -> int:
        return self._skipped_steps

    def minimize(self, optimizer, *args, **kwargs):
        if not self._enable:
            return optimizer.minimize(*args, **kwargs)
        if self._opt_states.get(id(optimizer)) != OptimizerState.UNSCALED:
            self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._note_skip()
        self._update()
        self._opt_states.pop(id(optimizer), None)
        optimizer.clear_grad()
        return None, None

    # -- scale accessors ----------------------------------------------------
    def get_loss_scaling(self) -> float:
        return self._loss_scaling

    def set_init_loss_scaling(self, v: float):
        self._init_loss_scaling = float(v)
        self._loss_scaling = float(v)

    def get_init_loss_scaling(self):
        return self._init_loss_scaling

    def set_incr_ratio(self, v):
        self._incr_ratio = float(v)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_decr_ratio(self, v):
        self._decr_ratio = float(v)

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_incr_every_n_steps(self, v):
        self._incr_every_n_steps = int(v)

    def get_incr_every_n_steps(self):
        return self._incr_every_n_steps

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every_n_nan_or_inf = int(v)

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every_n_nan_or_inf

    def state_dict(self) -> dict:
        if not self._enable:
            return {}
        return {
            "scale": np.asarray(self._loss_scaling, np.float32),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": self._incr_count,
            "decr_count": self._decr_count,
            "use_dynamic_loss_scaling": self._use_dynamic_loss_scaling,
        }

    def load_state_dict(self, state: dict):
        if not self._enable:
            if state:
                raise RuntimeError("Loaded state dict is not empty but the "
                                   "scaler is disabled")
            return
        self._loss_scaling = float(np.asarray(state["scale"]))
        self._incr_ratio = float(state["incr_ratio"])
        self._decr_ratio = float(state["decr_ratio"])
        self._incr_every_n_steps = int(state["incr_every_n_steps"])
        self._decr_every_n_nan_or_inf = int(state["decr_every_n_nan_or_inf"])
        self._incr_count = int(state.get("incr_count", 0))
        self._decr_count = int(state.get("decr_count", 0))


class GradScaler(AmpScaler):
    """The public scaler (`paddle.amp.GradScaler`)."""

    def step(self, optimizer):
        if not self._enable:
            return optimizer.step()
        if self._opt_states.get(id(optimizer)) == OptimizerState.STEPPED:
            raise RuntimeError("step() has already been called since the "
                               "last update()")
        if self._opt_states.get(id(optimizer)) != OptimizerState.UNSCALED:
            self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._note_skip()
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    def update(self):
        if not self._enable:
            return
        self._update()
        self._opt_states.clear()
