"""Serving-side fault tolerance: overload admission control, request
fault isolation and the engine watchdog (the port of
`paddle_tpu/serving/fault_tolerance.py`).

The contract it serves: every submitted request reaches a TERMINAL
status — FINISHED, TIMED_OUT, SHED, FAILED (or CANCELLED / REJECTED) —
no matter what the engine does. Three pieces, all consumed by
`serving/scheduler.py`:

- **Admission control / load shedding** (`AdmissionConfig` +
  `OverloadController`): watermark latches with hysteresis over queue
  depth, queued decode cost (the sum of `max_new_tokens` still owed) and
  KV-pool utilization, plus deadline-aware early shedding. Overload
  degrades to fast `SHED` responses for the overflow while admitted
  requests keep their latency.
- **Request fault isolation** (`EngineStepError`): a typed boundary
  around each engine dispatch. A fault attributable to specific lanes —
  NaN logits in a row, a typed `EngineStepError` carrying `seq_ids`, a
  cache failure while growing one sequence, a lane whose single-lane
  probe replay fails — fails ONLY those requests; the surviving lanes
  roll back to their pre-step cache lengths and replay next round with
  the tokens a fault-free run commits. Unattributable faults count as
  transient and are retried a bounded number of times before they
  escalate.
- **Engine watchdog** (`WatchdogConfig`): per-dispatch wall-clock stall
  detection plus zero-progress detection, driving a bounded-restart
  supervisor (`framework.retry.Budget`). A restart re-queues every
  in-flight sequence with its tokens so far (re-prefill on re-admission
  is token-deterministic), rebuilds the engine through `engine_factory`
  (retried via `framework.retry.retry_call`) and re-leases the guard
  block from the fresh `BlockCacheManager`. Out of budget, or without a
  factory, every non-terminal request fails typed instead of hanging.

`EngineStalled` is raised by `ServingFrontend.run_until_idle` / `stream`
after N consecutive zero-progress steps when no watchdog is installed.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

__all__ = ["AdmissionConfig", "EngineStalled", "EngineStepError",
           "OverloadController", "WatchdogConfig"]


class EngineStepError(RuntimeError):
    """One engine dispatch (prefill / decode / verify / sample) failed.

    Engines — or the fault injector — may raise it with ``seq_ids``
    naming the poisoned lane(s); the scheduler then fails ONLY those
    requests and replays the rest. Any other exception type is
    attributed by per-lane probe replays (or treated as transient when
    no lane is individually culpable)."""

    def __init__(self, phase: str, seq_ids: Sequence[int] = (),
                 message: Optional[str] = None):
        self.phase = phase
        self.seq_ids = tuple(int(s) for s in seq_ids)
        lanes = f" (lanes {list(self.seq_ids)})" if self.seq_ids else ""
        super().__init__(message or f"engine {phase} dispatch failed{lanes}")


class EngineStalled(RuntimeError):
    """The scheduler made no progress for ``steps`` consecutive rounds.

    Progress = at least one of {token produced, request admitted,
    request reached a terminal status} in a round. A non-idle scheduler
    that sustains zero progress is wedged (engine hung, leaked KV pool,
    admission deadlock) — this is the watchdog's restart trigger, and
    the typed error `run_until_idle`/`stream` raise instead of spinning
    forever when no watchdog is installed."""

    def __init__(self, steps: int, detail: str = ""):
        self.steps = steps
        tail = f": {detail}" if detail else ""
        super().__init__(f"engine stalled — {steps} consecutive "
                         f"zero-progress scheduler steps{tail}")


class AdmissionConfig:
    """Overload watermarks for admission-time load shedding.

    Every watermark pair is (high, low) with hysteresis: shedding for
    that reason starts when the signal reaches ``high`` and stops only
    once it falls back to ``low`` — no flapping at the boundary. A
    ``None`` high watermark disables that signal. Exact-boundary
    contract (pinned by tests): a submit observing ``signal >= high``
    sheds; once latched, a submit observing ``signal <= low`` admits.

    - ``queue_high``/``queue_low``: waiting-queue depth (requests).
    - ``cost_high``/``cost_low``: queued decode cost — the sum of
      ``max_new_tokens`` remaining over waiting requests. Weighting by
      requested tokens keeps a few 4096-token requests from hiding
      behind a depth-only watermark. The latch tracks the BACKLOG only,
      never the incoming request's own cost: a latch fed
      ``backlog + req_cost`` would let one oversize request latch
      shedding on an idle server and then turn away every mid-size
      request forever.
    - ``kv_high``/``kv_low``: `BlockCacheManager.utilization()` fraction.
    - ``deadline_aware``: shed a deadline-carrying request immediately
      when ``now + (queued_cost / lanes + max_new_tokens) * tpot *
      deadline_headroom`` exceeds its deadline — it would only time out
      later after consuming resources. Uses the scheduler's measured
      per-step TPOT (median of recent dispatch wall times); inactive
      until a first step has been timed.

    Low watermarks default to half (queue/cost) or ``high - 0.15``
    (kv) when omitted.
    """

    def __init__(self, queue_high: Optional[int] = None,
                 queue_low: Optional[int] = None,
                 cost_high: Optional[int] = None,
                 cost_low: Optional[int] = None,
                 kv_high: Optional[float] = None,
                 kv_low: Optional[float] = None,
                 deadline_aware: bool = True,
                 deadline_headroom: float = 1.0):
        def _default_low(high, low, frac_drop=None):
            if high is None or low is not None:
                return low
            return high // 2 if frac_drop is None else max(
                0.0, high - frac_drop)

        self.queue_high = queue_high
        self.queue_low = _default_low(queue_high, queue_low)
        self.cost_high = cost_high
        self.cost_low = _default_low(cost_high, cost_low)
        self.kv_high = kv_high
        self.kv_low = _default_low(kv_high, kv_low, frac_drop=0.15)
        self.deadline_aware = deadline_aware
        self.deadline_headroom = float(deadline_headroom)
        for name, high, low in (("queue", self.queue_high, self.queue_low),
                                ("cost", self.cost_high, self.cost_low),
                                ("kv", self.kv_high, self.kv_low)):
            if high is not None and low is not None and low > high:
                raise ValueError(f"{name}_low ({low}) must be <= "
                                 f"{name}_high ({high})")


class OverloadController:
    """Hysteresis state + the per-submit shed decision.

    Owned by the scheduler; pure host arithmetic so a shed answer costs
    microseconds — the whole point of shedding is that rejection is
    orders of magnitude cheaper than admission."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self._latched: Dict[str, bool] = {}

    def _hysteresis(self, reason: str, value, high, low) -> bool:
        if high is None:
            return False
        on = self._latched.get(reason, False)
        if not on and value >= high:
            on = True
        elif on and value <= low:
            on = False
        self._latched[reason] = on
        return on

    def shed_reason(self, *, queue_depth: int, queued_cost: int,
                    req_cost: int, kv_utilization: float,
                    deadline: Optional[float], now: float,
                    tpot_s: Optional[float], lanes: int) -> Optional[str]:
        """Return the shed reason for an incoming request, or None to
        admit. Signals are checked cheapest-first; each maintains its
        own hysteresis latch."""
        c = self.cfg
        if self._hysteresis("queue_depth", queue_depth,
                            c.queue_high, c.queue_low):
            return "queue_depth"
        if self._hysteresis("queue_cost", queued_cost,
                            c.cost_high, c.cost_low):
            return "queue_cost"
        if self._hysteresis("kv_pressure", kv_utilization,
                            c.kv_high, c.kv_low):
            return "kv_pressure"
        if c.deadline_aware and deadline is not None and tpot_s is not None:
            # one decode step advances every lane: a request ~max_new
            # steps of its own, behind ~queued_cost/lanes steps of queue
            est_s = ((queued_cost / max(lanes, 1)) + req_cost) \
                * tpot_s * c.deadline_headroom
            if now + est_s > deadline:
                return "deadline_unmeetable"
        return None


class WatchdogConfig:
    """Engine-watchdog knobs (all bounded, no sleeps).

    - ``stall_timeout_s``: per-dispatch wall-clock budget; a dispatch
      measured over it records a stall detection and triggers a restart
      at the end of the step (a synchronous host can only detect a
      stall post-hoc — the restart keeps the NEXT steps healthy).
    - ``stall_steps``: consecutive zero-progress scheduler rounds before
      the watchdog declares `EngineStalled` and restarts.
    - ``step_retries``: consecutive UNattributed (transient) dispatch
      faults tolerated before escalating to a restart.
    - ``max_restarts``: lifetime engine-restart budget
      (`framework.retry.Budget`); exhausting it fails every non-terminal
      request typed (`engine_unrecoverable:*`) instead of looping.
    - ``rebuild_retries``: `retry_call` attempts for the engine factory
      itself during one restart.
    """

    def __init__(self, stall_timeout_s: float = 30.0,
                 stall_steps: int = 256,
                 step_retries: int = 3,
                 max_restarts: int = 2,
                 rebuild_retries: int = 1):
        if stall_steps < 1 or step_retries < 0 or max_restarts < 0:
            raise ValueError("watchdog budgets must be non-negative "
                             f"(stall_steps >= 1): got stall_steps="
                             f"{stall_steps}, step_retries={step_retries}, "
                             f"max_restarts={max_restarts}")
        self.stall_timeout_s = float(stall_timeout_s)
        self.stall_steps = int(stall_steps)
        self.step_retries = int(step_retries)
        self.max_restarts = int(max_restarts)
        self.rebuild_retries = int(rebuild_retries)
