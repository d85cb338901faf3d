"""Elastic multichip training: detect → abort → re-form → reshard → resume
(the port of `paddle_tpu/resilience/elastic_train.py`).

Reference analog: the fleet elastic stack (`fleet/elastic/manager.py`
membership watch + scale in/out, the collective watchdogs, and
`paddle.distributed.checkpoint`'s reshard-on-load) composed into one
loop. Before this module every ingredient existed but nothing connected
them: a `CommWatchdog` trip dumped forensics and the job hung, a dead
host left a mesh of survivors waiting forever on a collective that
could never complete, and a checkpoint saved at world N could only be
restored at world N. At fleet scale a multichip training job IS a
failure domain — a host dying mid-step must cost seconds, not the job.

:class:`ElasticTrainSupervisor` closes the loop around a distributed
train step:

1. **Detection** — every pod heartbeats per-step through
   `ElasticManager` (payload = step, loss, step wall); failure is
   declared by the `reap_stale` sweep (a pod went silent), by a
   `CommWatchdog` trip (the new ``on_trip`` escalation raises the typed
   `CollectiveStalled` instead of dump-and-hang), or by a raised
   collective error (:class:`CollectiveAborted`). All three funnel to
   one typed :class:`WorldChanged` carrying the lost pods' final
   payloads and the mesh epoch that just died.
2. **Abort & re-form** — survivors fence the old mesh epoch: every
   surviving pod re-registers, bumping its incarnation, so writes
   carrying the dead epoch's incarnations are rejected at the store
   (`elastic.stale_heartbeats`), and the in-flight step's results are
   discarded by construction (post-reform state comes ONLY from the
   last verified checkpoint). The surviving world is agreed through a
   store barrier with quorum (`ElasticManager.wait_for_quorum`) and the
   `ProcessMesh`/device groups are rebuilt at the new world size.
3. **Reshard-on-resume** — `CheckpointManager.restore_latest` restores
   the world-N checkpoint at world M != N (``placements=`` re-places
   the destination templates; `distributed/checkpoint` re-slices saved
   shards on load), then training resumes under `StepGuard` rollback
   semantics. Losses from the restored step are token-for-token equal
   to an uninterrupted run at the new world size
   (`tools/elastic_workload.py` `chaos_smoke` asserts this bitwise).

The supervisor is exercised on the single-controller emulated world
(`distributed.set_emulated_world(n)`: one process plays every rank, one
pod a rank, the shards views of one global tensor on one card); the
multi-process convention is the next distributed slice's. The module
is **threaded** (heartbeat ticker + supervisor — registered with the
ptlint lock-hygiene pass): shared membership state (`_alive`,
`_incarnations`, `_last_payload`, `_stall`) is only touched under
``_lock``, and the per-step beat (`_beat`, a registered hot path) does
ONE store write with no imports, host transfers, or blocking extras.

Observability: ``elastic.reforms`` / ``elastic.lost_pods`` counters,
``elastic.recovery_ms`` / ``elastic.world_size`` gauges, an "Elastic:"
`profiler.summary()` section (the JAX package's; the port's profiler
is not ported yet), and a ``flight_elastic_reform_*.jsonl``
forensics dump naming each lost pod's final step/loss. Chaos sites
(`resilience/faults.py`): ``train.step`` (flag = kill the busiest pod
mid-step; a raised `CollectiveAborted` models a collective error),
``elastic.beat`` (flag = the victim's heartbeat silently stops reaching
the store), ``elastic.reform`` / ``elastic.reshard`` (failures inside
recovery itself).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.tensor import Tensor
from ..distributed.communication.watchdog import (CollectiveStalled,
                                                  CommWatchdog)
from ..distributed.elastic import ElasticManager
from ..framework import monitor
from . import faults
from .checkpoint_manager import CheckpointManager
from .guard import NoValidCheckpoint, StepGuard

__all__ = ["WorldChanged", "CollectiveAborted", "CollectiveStalled",
           "QuorumLost", "ReformBudgetExceeded", "ElasticTrainSupervisor",
           "EmulatedTrainable", "make_emulated_trainable"]


class CollectiveAborted(RuntimeError):
    """A collective failed because a participant died (the survivors'
    NCCL-abort analog). Carries the pod whose death aborted it."""

    def __init__(self, pod_id: str, detail: str = ""):
        self.pod_id = pod_id
        super().__init__(f"collective aborted: pod '{pod_id}' lost"
                         + (f" ({detail})" if detail else ""))


class WorldChanged(Exception):
    """THE detection funnel: every failure signal (reap sweep, watchdog
    stall, aborted collective) becomes one of these. ``lost_pods`` maps
    each lost pod to the last heartbeat payload it ever delivered
    (final step/loss/step-wall — None if it never beat); ``epoch`` is
    the mesh epoch that died with them."""

    def __init__(self, lost_pods: Dict[str, Optional[dict]], epoch: int,
                 detected_at: Optional[float] = None, cause: str = ""):
        self.lost_pods = dict(lost_pods)
        self.epoch = int(epoch)
        self.detected_at = detected_at
        self.cause = cause
        super().__init__(f"world changed (epoch {epoch}, {cause or 'lost'}:"
                         f" {sorted(self.lost_pods)})")


class QuorumLost(RuntimeError):
    """Re-formation found fewer than ``min_world`` survivors before the
    quorum deadline: the job must abort rather than silently train a
    world the operator never approved."""


class ReformBudgetExceeded(RuntimeError):
    """More mesh re-formations than ``reform_budget`` allows — the
    fleet is flapping; stop burning accelerator hours and page."""


# ---------------------------------------------------------------------------
# emulated trainable (the dryrun_multichip substrate)
# ---------------------------------------------------------------------------
class EmulatedTrainable:
    """A sharded train step over the emulated world: one rank a
    surviving pod, parameters and momentum placed over the 1-D ``world``
    mesh.

    Placement rule (docs/RESILIENCE.md "reshard rules"): a tensor's
    leading dim is sharded over ``world`` iff it divides evenly,
    otherwise the tensor is replicated, so a world size that does not
    divide the parameter (8 -> 7) still trains, while divisible worlds
    (8 -> 4 -> 2) genuinely re-slice. The loss contracts over the
    sharded dimension and carries the JAX package's real collective:
    with ``w`` row-sharded, ``x @ w`` is each rank's product of its
    column block of ``x`` with its rows of ``w``, stacked and summed over
    the rank axis in rank order (an all-reduce); replicated, it is one
    product. Per-step data is host-generated from ``data_seed + step``,
    so a restored run recomputes bit for bit the steps an uninterrupted
    run at the same world size would. The state lives on ``device`` (the
    expected place when None: the card unless the caller asks for the
    CPU)."""

    def __init__(self, world: List[str], hidden: int = 8, batch: int = 8,
                 seed: int = 0, data_seed: int = 1000, lr: float = 0.05,
                 device=None):
        from ..distributed.auto_parallel import sharding_bridge as sb
        from ..distributed.placement import Replicate, Shard
        from ..distributed.process_mesh import ProcessMesh
        from ..framework.place import expected_device

        self.world = list(world)
        n = len(self.world)
        if n < 1:
            raise ValueError("empty world")
        self.pmesh = ProcessMesh(np.arange(n), ["world"])
        self.hidden = int(hidden)
        self.batch = int(batch)
        self.data_seed = int(data_seed)
        self._lr = float(lr)
        self.device = expected_device(device)

        def spec(shape):
            return sb.DistMeta(self.pmesh, [
                Shard(0) if shape and shape[0] % n == 0 else Replicate()])

        rng = np.random.default_rng(seed)
        init = {
            "w": (rng.standard_normal((hidden, hidden)) * 0.1
                  ).astype(np.float32),
            "b": np.zeros((hidden,), np.float32),
            "m_w": np.zeros((hidden, hidden), np.float32),
            "m_b": np.zeros((hidden,), np.float32),
        }
        self._metas = {k: spec(v.shape) for k, v in init.items()}
        self._state = {}
        for k, v in init.items():
            t = Tensor(torch.from_numpy(v).to(self.device))
            sb.set_meta(t, self._metas[k])
            self._state[k] = t

    # -- supervisor protocol -------------------------------------------------
    def state_dict(self) -> Dict[str, Tensor]:
        return self._state

    def placements(self) -> Dict[str, object]:
        """Target placements for reshard-on-resume: keys match
        `state_dict`, values are this world's `DistMeta`s."""
        return dict(self._metas)

    def _contract(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w``: with ``w`` row-sharded, the per-rank products
        summed over the rank axis in rank order."""
        from ..distributed.auto_parallel import sharding_bridge as sb

        meta = self._metas["w"]
        if not meta.placements[0].is_shard():
            return x @ w
        shards = sb.local_shards(w, meta)
        parts = torch.stack([x[:, off[0]:off[0] + v.shape[0]] @ v
                             for _rank, off, v in shards])
        return sb.reduce_stacked(parts, "sum")

    def step(self, step_idx: int) -> float:
        rng = np.random.default_rng(self.data_seed + step_idx)
        x = rng.standard_normal((self.batch, self.hidden)).astype(np.float32)
        y = rng.standard_normal((self.batch, self.hidden)).astype(np.float32)
        x = torch.from_numpy(x).to(self.device)
        y = torch.from_numpy(y).to(self.device)
        st = {k: t._data for k, t in self._state.items()}
        w = st["w"].detach().requires_grad_(True)
        b = st["b"].detach().requires_grad_(True)
        with torch.enable_grad():
            pred = torch.tanh(self._contract(x, w)) + b
            loss = torch.mean((pred - y) ** 2)
            gw, gb = torch.autograd.grad(loss, [w, b])
        with torch.no_grad():
            for k, g in (("w", gw), ("b", gb)):
                m = 0.9 * st["m_" + k] + g
                st["m_" + k].copy_(m)
                st[k].copy_(st[k] - self._lr * m)
        return float(loss.detach().cpu())

    def gather(self) -> Dict[str, np.ndarray]:
        """Host copies of the full (unsharded) state: what the world-
        shape tests compare bit for bit across save / restore world
        sizes."""
        return {k: t._data.detach().cpu().numpy().copy()
                for k, t in self._state.items()}


def make_emulated_trainable(hidden: int = 8, batch: int = 8, seed: int = 0,
                            data_seed: int = 1000, lr: float = 0.05,
                            device=None
                            ) -> Callable[[List[str]], EmulatedTrainable]:
    """`build_trainable` factory for the supervisor: rebuilds the
    sharded step at whatever world size the reform agreed on."""

    def build(world: List[str]) -> EmulatedTrainable:
        return EmulatedTrainable(world, hidden=hidden, batch=batch,
                                 seed=seed, data_seed=data_seed, lr=lr,
                                 device=device)

    return build


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------
class _HeartbeatTicker(threading.Thread):
    """Background lease keeper: re-beats every live pod's last payload
    between steps so a long step/compile cannot look like mass death.
    ``wait`` is injectable (Event.wait contract: True = stop set)."""

    def __init__(self, supervisor: "ElasticTrainSupervisor",
                 interval_s: float,
                 wait: Optional[Callable[[float], bool]] = None):
        super().__init__(daemon=True, name="elastic-heartbeat-ticker")
        self._supervisor = supervisor
        self._interval = float(interval_s)
        self._stop_evt = threading.Event()
        self._wait = wait if wait is not None else self._stop_evt.wait

    def stop(self) -> None:
        self._stop_evt.set()

    def run(self) -> None:
        while not self._wait(self._interval):
            try:
                self._supervisor._tick_beat()
            except Exception:
                # a dying store must surface on the supervisor's own
                # beats, not kill the lease keeper silently mid-run
                monitor.inc("elastic.ticker_errors")


class ElasticTrainSupervisor:
    """Wraps a distributed train step in the detect → abort → re-form →
    reshard → resume loop (module docstring has the full contract).

    ``build_trainable(world)`` must return an object with
    ``step(step_idx) -> loss`` (or ``(loss, grad_norm)``),
    ``state_dict() -> Dict[str, Tensor]`` of the sharded train state,
    and optionally ``placements() -> Dict[str, Sharding]`` (the
    reshard-on-resume targets). `EmulatedTrainable` is the built-in
    reference implementation over the emulated world.

    Time flows only through ``clock`` (and the membership store's own
    injectable clock), so every failure path — silence, stall, abort,
    quorum timeout — tests with zero real sleeps.
    """

    def __init__(self, build_trainable, manager: ElasticManager,
                 ckpt: CheckpointManager, pods: List[str],
                 min_world: int = 2, save_every: int = 1,
                 reform_budget: int = 3,
                 quorum_deadline_s: float = 30.0,
                 reap_timeout_s: Optional[float] = None,
                 step_timeout_s: Optional[float] = None,
                 stall_action: Optional[str] = None,
                 heartbeat_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time,
                 victim_fn=None, watchdog_wait=None,
                 ticker_wait=None, guard_kw: Optional[dict] = None):
        if not pods:
            raise ValueError("supervisor needs at least one pod")
        if min_world < 1 or min_world > len(pods):
            raise ValueError(f"min_world {min_world} outside [1, "
                             f"{len(pods)}]")
        self.build_trainable = build_trainable
        self.manager = manager
        self.ckpt = ckpt
        self.pods = list(pods)
        self.min_world = int(min_world)
        self.save_every = int(save_every)
        self.reform_budget = int(reform_budget)
        self.quorum_deadline_s = float(quorum_deadline_s)
        self.reap_timeout_s = reap_timeout_s
        self.step_timeout_s = step_timeout_s
        # what a trip does when the step is STILL blocked in the
        # collective (nothing in-process can unwedge it): the watchdog
        # flag default ("kill" -> exit 124 -> launcher relaunch ->
        # checkpoint resume). In-process re-formation handles the stalls
        # where the dispatch does return.
        self.stall_action = stall_action
        self.heartbeat_interval_s = heartbeat_interval_s
        self._clock = clock
        self._victim_fn = victim_fn
        self._watchdog_wait = watchdog_wait
        self._ticker_wait = ticker_wait
        self._guard_kw = dict(guard_kw or {})

        self.epoch = 1
        self.world: List[str] = []
        self.reforms = 0
        self.losses: Dict[int, float] = {}
        self.last_recovery_ms: Optional[float] = None
        self.last_restored_step: Optional[int] = None
        self.trainable = None
        self._guard: Optional[StepGuard] = None
        self._ticker: Optional[_HeartbeatTicker] = None
        self._recovery_t0: Optional[float] = None
        self._stall: Optional[BaseException] = None
        self._in_dispatch = False
        self._lock = threading.Lock()
        self._alive = set()
        self._silenced = set()
        self._incarnations: Dict[str, int] = {}
        self._last_payload: Dict[str, dict] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ElasticTrainSupervisor":
        """Register every pod (fresh incarnations), build the trainable
        at the full world, and resume from the latest valid checkpoint if
        one exists (same-world resume; cross-world restore happens in
        `_reform`). A restart (`close()` then `start()`) is a NEW run:
        every piece of per-run failure state — silenced pods, stale
        payloads, a noted stall, the loss trajectory, the reform count —
        resets; only the epoch stays monotonic (its incarnation fences
        must outlive restarts)."""
        with self._lock:
            self._alive.clear()
            self._alive.update(self.pods)
            self._silenced.clear()
            self._last_payload.clear()
            self._stall = None
            self._in_dispatch = False
        self.losses.clear()
        self.reforms = 0
        self.last_recovery_ms = None
        self.last_restored_step = None
        self._recovery_t0 = None
        for pod in sorted(self.pods):
            inc = self.manager.register(pod, payload={"epoch": self.epoch})
            with self._lock:
                self._incarnations[pod] = inc
        self.world = sorted(self.pods)
        self.trainable = self.build_trainable(self.world)
        self._guard = self._make_guard()
        res = self.ckpt.restore_latest(
            state_dict=self.trainable.state_dict(),
            placements=self._placements())
        if res is not None:
            self._guard.last_step = res.step
            self.last_restored_step = res.step
        monitor.set_gauge("elastic.world_size", len(self.world))
        if self.heartbeat_interval_s:
            self._ticker = _HeartbeatTicker(self, self.heartbeat_interval_s,
                                            wait=self._ticker_wait)
            self._ticker.start()
        return self

    def close(self) -> None:
        t, self._ticker = self._ticker, None
        if t is not None:
            t.stop()
            t.join(timeout=5.0)  # outside the lock: lock-hygiene contract

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the supervised loop -------------------------------------------------
    def run(self, num_steps: int) -> Dict[int, float]:
        """Train to ``num_steps`` steps surviving world changes; returns
        the final {step: loss} trajectory (replayed steps overwrite the
        abandoned epoch's values — the dict IS the surviving history)."""
        if self._guard is None:
            self.start()
        while True:
            step_idx = self._guard.last_step + 1
            if step_idx >= num_steps:
                break
            try:
                self._supervised_step(step_idx)
            except WorldChanged as wc:
                self._reform(wc)
        return dict(self.losses)

    def _supervised_step(self, step_idx: int) -> Optional[float]:
        t0 = self._clock()
        try:
            loss = self._guard.step(step_idx)
        except CollectiveAborted as exc:
            self._pod_dies(exc.pod_id)
            raise WorldChanged({exc.pod_id: self._payload_of(exc.pod_id)},
                               self.epoch, detected_at=self._clock(),
                               cause="collective_abort") from exc
        except CollectiveStalled as exc:
            victim = self._victim()
            self._pod_dies(victim)
            raise WorldChanged({victim: self._payload_of(victim)},
                               self.epoch, detected_at=self._clock(),
                               cause="watchdog_stall") from exc
        wall_ms = round((self._clock() - t0) * 1000.0, 3)
        if loss is not None:  # None = StepGuard rollback (replayed next)
            self._beat(step_idx, loss, wall_ms)
            # the step is real the moment it completes — a world change
            # found by the sweep below must not un-record it (the step's
            # checkpoint is the very restore point the reform uses)
            self.losses[step_idx] = loss
            if self._recovery_t0 is not None:
                # first post-resume step landed: the recovery claim is
                # kill-to-training-again, not kill-to-reform-returned
                self.last_recovery_ms = round(
                    (self._clock() - self._recovery_t0) * 1000.0, 3)
                monitor.set_gauge("elastic.recovery_ms",
                                  self.last_recovery_ms)
                self._recovery_t0 = None
        self._sweep()
        return loss

    def _wrapped_step(self, step_idx: int):
        """The guarded body: chaos site + watchdog around the real step.
        ``train.step`` armed with ``action="flag"`` kills the busiest
        pod mid-step (its collective aborts); ``action="raise"`` with a
        `CollectiveAborted`/`CollectiveStalled` exc models the failure
        directly (other exceptions stay StepGuard anomalies)."""
        if faults.check_flag("train.step"):
            victim = self._victim()
            self._pod_dies(victim)
            raise CollectiveAborted(victim, "chaos kill mid-step")
        # in-dispatch is flagged BEFORE the watchdog can possibly trip:
        # a trip landing in a pre-dispatch window would otherwise read
        # "not dispatching" as "handled" and suppress the last resort
        # right before the caller wedges in the collective
        with self._lock:
            self._in_dispatch = True
        wd = None
        if self.step_timeout_s:
            wd = CommWatchdog("train.step", timeout=self.step_timeout_s,
                              action=self.stall_action,
                              meta={"step": step_idx, "epoch": self.epoch},
                              wait=self._watchdog_wait,
                              on_trip=self._note_stall)
            wd.start()
        try:
            out = self.trainable.step(step_idx)
        finally:
            with self._lock:
                self._in_dispatch = False
            if wd is not None:
                wd.finish()
                if wd._thread is not None:
                    wd._thread.join(timeout=5.0)
        stall = self._take_stall()
        if stall is not None:
            raise stall
        return out

    def _make_guard(self) -> StepGuard:
        kw = dict(save_every=self.save_every, exit_on_preempt=False)
        kw.update(self._guard_kw)
        return StepGuard(self._wrapped_step, self.ckpt,
                         state_dict=self.trainable.state_dict(),
                         placements=self._placements(),
                         escalate=(CollectiveAborted, CollectiveStalled),
                         **kw)

    def _placements(self) -> Optional[Dict[str, object]]:
        fn = getattr(self.trainable, "placements", None)
        return fn() if callable(fn) else None

    # -- detection -----------------------------------------------------------
    def _beat(self, step_idx: int, loss: float, wall_ms: float) -> None:
        """One store write renews every surviving lease with this step's
        payload. Registered hot path: no imports, no host transfers, no
        blocking extras beyond the single membership write."""
        drop = self._victim() if faults.fires("elastic.beat") else None
        with self._lock:
            if drop is not None:
                # "went silent" is a state, not one missed write: the
                # ticker must not quietly renew the victim's lease either
                self._silenced.add(drop)
            pods = sorted(self._alive - self._silenced)
            incs = {p: self._incarnations[p] for p in pods}
        payloads = {p: {"pod": p, "step": step_idx, "loss": loss,
                        "step_wall_ms": wall_ms, "epoch": self.epoch}
                    for p in pods}
        self.manager.heartbeat_many(pods, incarnations=incs,
                                    payloads=payloads)
        with self._lock:
            self._last_payload.update(payloads)

    def _tick_beat(self) -> None:
        """Ticker-thread lease renewal between steps (last payloads)."""
        with self._lock:
            pods = sorted(self._alive - self._silenced)
            incs = {p: self._incarnations[p] for p in pods}
            payloads = {p: self._last_payload[p] for p in pods
                        if p in self._last_payload}
        if pods:
            self.manager.heartbeat_many(pods, incarnations=incs,
                                        payloads=payloads)

    def _sweep(self) -> None:
        """Silence detection: reap leases whose heartbeat lapsed; any
        reaped pod we still thought alive is a world change."""
        reaped, payloads = self.manager.reap_stale(
            timeout_s=self.reap_timeout_s, return_payloads=True)
        with self._lock:
            lost = [p for p in reaped if p in self._alive]
            for p in lost:
                self._alive.discard(p)
                self._silenced.discard(p)
        if lost:
            final = {p: payloads.get(p) or self._payload_of(p)
                     for p in lost}
            raise WorldChanged(final, self.epoch,
                               detected_at=self._clock(), cause="reaped")

    def _pod_dies(self, pod: str) -> None:
        with self._lock:
            self._alive.discard(pod)
            self._silenced.discard(pod)

    def _victim(self) -> str:
        """The busiest live pod: highest last-reported step wall, ties
        broken by pod id (deterministic — the chaos smoke and the
        straggler attribution both need a reproducible choice)."""
        with self._lock:
            alive = sorted(self._alive)
            walls = {p: (self._last_payload.get(p) or {}).get(
                "step_wall_ms", 0.0) for p in alive}
        if self._victim_fn is not None:
            return self._victim_fn(alive, walls)
        if not alive:
            raise RuntimeError("no live pods to attribute a failure to")
        return max(alive, key=lambda p: (walls[p], p))

    def _payload_of(self, pod: str) -> Optional[dict]:
        with self._lock:
            return self._last_payload.get(pod)

    def _note_stall(self, exc: BaseException) -> bool:
        """Watchdog escalation hook. Returns True ("handled") only when
        the dispatch has already returned — the step boundary will raise
        the typed stall and the supervisor re-forms in-process. While
        the caller is still blocked inside the collective, nothing
        in-process can unwedge it: return False so the watchdog falls
        through to its action (default kill -> exit 124 -> launcher
        relaunch -> checkpoint resume), exactly the pre-escalation
        guarantee."""
        with self._lock:
            self._stall = exc
            return not self._in_dispatch

    def _take_stall(self) -> Optional[BaseException]:
        with self._lock:
            exc, self._stall = self._stall, None
        return exc

    # -- abort & re-form -----------------------------------------------------
    def _reform(self, wc: WorldChanged) -> None:
        """Fence the dead epoch, agree on the surviving world (quorum),
        rebuild the mesh, reshard the latest checkpoint onto it, and arm
        a fresh StepGuard at the restored step."""
        self.reforms += 1
        if self.reforms > self.reform_budget:
            raise ReformBudgetExceeded(
                f"{self.reforms} mesh re-formations exceed reform_budget="
                f"{self.reform_budget}; last loss: {sorted(wc.lost_pods)}")
        monitor.inc("elastic.reforms")
        monitor.inc("elastic.lost_pods", len(wc.lost_pods))
        faults.check("elastic.reform")
        old_world = list(self.world)
        # 1. fence: the dead epoch's incarnations must never write again.
        #    report_dead is incarnation-fenced (a reaped pod is already
        #    gone; deregistering a successor is impossible by design) and
        #    every survivor re-registers under the NEW epoch, so a beat
        #    carrying a pre-reform incarnation is rejected at the store.
        self.epoch += 1
        with self._lock:
            for pod in wc.lost_pods:
                self._alive.discard(pod)
                self._silenced.discard(pod)
            dead_incs = {p: self._incarnations.get(p)
                         for p in wc.lost_pods}
            alive = sorted(self._alive)
        for pod, inc in dead_incs.items():
            self.manager.report_dead(pod, incarnation=inc)
        for pod in alive:
            inc = self.manager.register(pod, payload={"epoch": self.epoch})
            with self._lock:
                self._incarnations[pod] = inc
        # 2. survivor consensus: quorum barrier over the store
        world = self.manager.wait_for_quorum(self.min_world,
                                             self.quorum_deadline_s)
        if world is None:
            raise QuorumLost(
                f"reform after losing {sorted(wc.lost_pods)}: fewer than "
                f"min_world={self.min_world} pods before the "
                f"{self.quorum_deadline_s}s quorum deadline")
        # 3. rebuild the mesh + reshard the checkpoint onto it. The
        #    aborted step's in-flight results are discarded here by
        #    construction: the new trainable starts from nothing but the
        #    last verified checkpoint.
        faults.check("elastic.reshard")
        self.trainable = self.build_trainable(world)
        res = self.ckpt.restore_latest(
            state_dict=self.trainable.state_dict(),
            placements=self._placements())
        if res is None:
            raise NoValidCheckpoint(
                f"reform to world {len(world)} has no valid checkpoint "
                f"to reshard under {self.ckpt.root}")
        self._guard = self._make_guard()
        self._guard.last_step = res.step
        self.last_restored_step = res.step
        self.world = world
        monitor.set_gauge("elastic.world_size", len(world))
        self._recovery_t0 = (wc.detected_at if wc.detected_at is not None
                             else self._clock())
        self._dump_reform(wc, old_world, world, res.step)

    def _dump_reform(self, wc: WorldChanged, old_world: List[str],
                     new_world: List[str], restored_step: int) -> None:
        """Forensics flight dump (always on, like watchdog trips): who
        was lost at which step/loss, what the world became, where
        training resumed."""
        from ..observability import timeline

        timeline.dump_elastic_reform(
            {"cause": wc.cause, "epoch_died": wc.epoch,
             "epoch_new": self.epoch,
             "old_world": old_world, "new_world": new_world,
             "restored_step": restored_step, "reforms": self.reforms},
            wc.lost_pods)
