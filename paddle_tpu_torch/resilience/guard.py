"""Step guard: anomaly detection and rollback around a training step,
the port of `paddle_tpu/resilience/guard.py`.

The guard wraps a train-step callable and
- detects a **non-finite loss** (NaN / Inf) the moment it appears;
- detects **loss / grad-norm spikes**: a value more than `threshold`
  times the rolling median of the last `window` good values;
- **composes with AMP**: a `GradScaler` skip (found-inf, step skipped,
  scale halved) is not an anomaly, but more than `max_scaler_skips`
  consecutive skips trip the guard;
- on a trip **rolls back** to the newest verified checkpoint (parameters,
  optimizer accumulators, scaler, RNG state: the replayed steps are the
  steps the run would have taken, bit for bit), at most `max_restarts`
  times (`RestartBudgetExceeded` past it);
- checkpoints every `save_every` steps;
- installs an optional **SIGTERM hook** that takes one emergency
  checkpoint, deferred to the step boundary when the signal lands inside
  a step, then raises `Preempted` (exit code 143);
- re-raises the exception types in `escalate` instead of rolling back.

Counters: `resilience.rollbacks`, `resilience.trips.<reason>`,
`resilience.scaler_skips`, beside the manager's.
"""
from __future__ import annotations

import math
import signal as _signal
import statistics
from collections import deque
from typing import Callable, Optional

from ..framework import monitor
from . import faults
from .checkpoint_manager import CheckpointManager

__all__ = ["StepGuard", "RestartBudgetExceeded", "NoValidCheckpoint",
           "Preempted"]


class RestartBudgetExceeded(RuntimeError):
    """The guard tripped more than ``max_restarts`` times."""


class NoValidCheckpoint(RuntimeError):
    """The guard tripped but `latest_valid()` found nothing to roll back
    to (no checkpoint was ever completed, or all are quarantined)."""


class Preempted(SystemExit):
    """Raised (code 143) after the emergency checkpoint when a preemption
    signal arrives and ``exit_on_preempt`` is set."""

    def __init__(self):
        super().__init__(143)


class StepGuard:
    def __init__(self, step_fn: Callable, manager: CheckpointManager,
                 model=None, optimizer=None, scaler=None,
                 window: int = 8, threshold: float = 10.0,
                 max_restarts: int = 3, max_scaler_skips: Optional[int] = 20,
                 save_every: Optional[int] = None,
                 exit_on_preempt: bool = True,
                 state_dict=None, placements=None,
                 escalate: tuple = ()):
        """``state_dict``: guard a train state (a dict of Tensors) instead
        of a model/optimizer pair (``placements``: the target placements
        each restore re-places it onto) —
        saves and rollbacks flow the dict (with its target shardings)
        through the manager, the elastic supervisor's path. ``escalate``
        names exception types the guard must NOT treat as a trip-and-
        rollback anomaly: mesh-level failures (a lost pod's aborted
        collective, a watchdog stall) re-raise to the supervisor that
        owns the fence/re-form/reshard response — rolling the surviving
        state back cannot cure a dead host."""
        self.step_fn = step_fn
        self.manager = manager
        self.model = model
        self.optimizer = optimizer
        self.scaler = scaler
        self.state_dict = state_dict
        self.placements = placements
        self.escalate = tuple(escalate)
        self.window = int(window)
        self.threshold = float(threshold)
        self.max_restarts = int(max_restarts)
        self.max_scaler_skips = max_scaler_skips
        self.save_every = save_every
        self.exit_on_preempt = bool(exit_on_preempt)
        self._losses = deque(maxlen=self.window)
        self._grad_norms = deque(maxlen=self.window)
        self.restarts = 0
        self.last_step = -1       # last *completed* (good or skipped) step
        self.last_restored_step = None
        self._consecutive_skips = 0
        self._prev_handlers = {}
        self._in_step = False
        self._pending_preempt: Optional[int] = None
        self._seen_scaler_skips = (scaler.get_skipped_steps()
                                   if scaler is not None else 0)

    # -- the guarded step ---------------------------------------------------
    def step(self, step_idx: int, *args, **kwargs) -> Optional[float]:
        """Run one guarded train step. Returns the (finite) loss, or None
        when the guard tripped and rolled back — the caller's loop simply
        recomputes from the restored state. An AMP-skipped step returns
        the loss too (it is not an anomaly)."""
        faults.check("guard.preempt")   # simulated preemption point
        self._fire_pending_preempt()    # signal deferred from a prior step
        # _in_step covers the WHOLE guarded body — step_fn, loss checks,
        # last_step update, periodic save — not just the step_fn call: a
        # signal landing after step_fn returns but before last_step is
        # bumped would otherwise checkpoint post-step-N state labelled N-1
        self._in_step = True
        try:
            result = self._step_inner(step_idx, *args, **kwargs)
        finally:
            self._in_step = False
        self._fire_pending_preempt()    # boundary: state is consistent now
        return result

    def _step_inner(self, step_idx: int, *args, **kwargs) -> Optional[float]:
        try:
            faults.check("guard.step")  # injected step exception
            out = self.step_fn(step_idx, *args, **kwargs)
        except (Preempted, RestartBudgetExceeded, NoValidCheckpoint):
            raise
        except self.escalate:
            raise               # mesh-level failure: the supervisor's call
        except Exception as exc:
            return self._trip("exception", repr(exc))
        loss, grad_norm = out if isinstance(out, tuple) else (out, None)
        loss = float(loss)
        if faults.fires("guard.nan_loss"):
            loss = float("nan")
        if self.scaler is not None and self._scaler_skipped_this_step():
            # AMP found-inf skip: normal dynamic-loss-scaling behaviour,
            # not an anomaly — unless it repeats past the budget
            self._consecutive_skips += 1
            monitor.inc("resilience.scaler_skips")
            if (self.max_scaler_skips is not None
                    and self._consecutive_skips > self.max_scaler_skips):
                return self._trip("scaler_stuck",
                                  f"{self._consecutive_skips} consecutive "
                                  "found-inf skips")
            self.last_step = step_idx
            self._maybe_periodic_save(step_idx)  # a skip still checkpoints
            return loss
        self._consecutive_skips = 0
        if not math.isfinite(loss):
            return self._trip("non_finite_loss", f"loss={loss}")
        if self._spikes(loss, self._losses):
            return self._trip("loss_spike",
                              f"loss={loss} vs median "
                              f"{statistics.median(self._losses)}")
        if grad_norm is not None:
            grad_norm = float(grad_norm)
            if not math.isfinite(grad_norm):
                return self._trip("non_finite_grad", f"grad_norm={grad_norm}")
            if self._spikes(grad_norm, self._grad_norms):
                return self._trip("grad_spike", f"grad_norm={grad_norm}")
            self._grad_norms.append(grad_norm)
        self._losses.append(loss)
        self.last_step = step_idx
        self._maybe_periodic_save(step_idx)
        return loss

    def _scaler_skipped_this_step(self) -> bool:
        """Did the scaler skip during THIS guarded step? Uses the skip-count
        delta rather than `last_step_skipped()` — the boolean is sticky, so
        a guarded step that never calls `scaler.step()` (e.g. gradient
        accumulation micro-steps) would re-read the previous decision and
        count phantom skips."""
        n = self.scaler.get_skipped_steps()
        skipped = n > self._seen_scaler_skips
        self._seen_scaler_skips = n
        return skipped

    def _maybe_periodic_save(self, step_idx: int) -> None:
        if self.save_every and (step_idx + 1) % self.save_every == 0:
            self.manager.save(step_idx, model=self.model,
                              optimizer=self.optimizer, scaler=self.scaler,
                              state_dict=self.state_dict)

    def _spikes(self, value: float, window) -> bool:
        if len(window) < self.window:
            return False
        median = statistics.median(window)
        # a multiplicative threshold is only meaningful on a positive
        # baseline; for negative-loss objectives (ELBO, log-likelihood)
        # `value > threshold * median` would trip on EVERY healthy step,
        # so spike detection stands down (non-finite detection still runs)
        return median > 0 and value > self.threshold * median

    # -- rollback -----------------------------------------------------------
    def _trip(self, reason: str, detail: str) -> None:
        monitor.inc(f"resilience.trips.{reason}")
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RestartBudgetExceeded(
                f"guard tripped {self.restarts} times (> max_restarts="
                f"{self.max_restarts}); last: {reason}: {detail}")
        res = self.manager.restore_latest(model=self.model,
                                          optimizer=self.optimizer,
                                          scaler=self.scaler,
                                          state_dict=self.state_dict,
                                          placements=self.placements)
        if res is None:
            raise NoValidCheckpoint(
                f"guard tripped ({reason}: {detail}) but no valid "
                f"checkpoint exists under {self.manager.root}")
        monitor.inc("resilience.rollbacks")
        # anomaly history belongs to the abandoned trajectory
        self._losses.clear()
        self._grad_norms.clear()
        self._consecutive_skips = 0
        self.last_restored_step = res.step
        self.last_step = res.step
        return None

    # -- preemption ---------------------------------------------------------
    def install_preemption_hook(self, signals=(_signal.SIGTERM,)) -> None:
        """On each signal: one emergency synchronous checkpoint of the
        current state, then `Preempted` (unless ``exit_on_preempt`` is
        False, in which case training may continue — e.g. the notice was
        advisory). Idempotent per signal; `uninstall_preemption_hook`
        restores the previous handlers.

        A signal that lands *inside* ``step_fn`` is deferred to the step
        boundary: Python delivers handlers at arbitrary bytecode
        boundaries, and a checkpoint taken between ``optimizer.step()``
        and the step's return would label post-step-N params as step N-1 —
        a resume would then apply step N twice and silently diverge."""

        def handler(signum, frame):
            if self._in_step:
                self._pending_preempt = int(signum)
                return
            self._emergency(int(signum))

        for sig in signals:
            if sig not in self._prev_handlers:
                self._prev_handlers[sig] = _signal.signal(sig, handler)

    def _fire_pending_preempt(self) -> None:
        if self._pending_preempt is not None:
            signum, self._pending_preempt = self._pending_preempt, None
            self._emergency(signum)

    def _emergency(self, signum: int) -> None:
        if self.last_step >= 0:
            # nothing-completed-yet (last_step == -1) saves nothing: a
            # checkpoint of untrained params labelled step 0 would make
            # the resume skip step 0's training silently
            self.manager.emergency_save(
                self.last_step, model=self.model,
                optimizer=self.optimizer, scaler=self.scaler,
                state_dict=self.state_dict,
                extras={"preempt_signal": int(signum)})
        if self.exit_on_preempt:
            raise Preempted()

    def uninstall_preemption_hook(self) -> None:
        for sig, prev in self._prev_handlers.items():
            _signal.signal(sig, prev)
        self._prev_handlers.clear()
