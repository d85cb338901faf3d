"""Elastic membership manager (the port's copy of
`paddle_tpu/distributed/elastic/manager.py`).

Members register as pods in a `MembershipStore`; on a failure the dead
pod is deregistered (fenced by its incarnation), silent pods are reaped
by TTL, and the manager waits a stabilization window for replacements
and joiners before it regenerates the dense rank order and reports the
new world. The serving fleet (`serving/fleet.py`) keeps its replicas'
leases through it.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from ...framework import monitor
from .store import MembershipStore

__all__ = ["ElasticManager"]


class ElasticManager:
    def __init__(self, store: MembershipStore, min_nodes: int,
                 max_nodes: int, stabilize_s: float = 1.0,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep):
        """``clock``/``sleep`` are injectable (the `framework/retry.py`
        pattern), so membership tests drive `wait_for_world`
        deterministically with zero real sleeps."""
        if min_nodes < 1 or max_nodes < min_nodes:
            raise ValueError(
                f"invalid elastic range [{min_nodes}, {max_nodes}]")
        self.store = store
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.stabilize_s = float(stabilize_s)
        self._clock = clock
        self._sleep = sleep

    # -- membership ---------------------------------------------------------
    def register(self, pod_id: str, endpoint: str = "",
                 payload: Optional[dict] = None) -> int:
        """Register (or re-register) a pod; returns its incarnation
        epoch — pass it back on every heartbeat so a dead predecessor's
        beats cannot refresh this registration."""
        return self.store.register(pod_id, endpoint, payload=payload)

    def heartbeat(self, pod_id: str, incarnation: Optional[int] = None,
                  payload: Optional[dict] = None) -> bool:
        return self.store.heartbeat(pod_id, incarnation=incarnation,
                                    payload=payload)

    def heartbeat_many(self, pod_ids, incarnations=None,
                       payloads=None) -> List[str]:
        return self.store.heartbeat_many(pod_ids, incarnations=incarnations,
                                         payloads=payloads)

    def report_dead(self, pod_id: str,
                    incarnation: Optional[int] = None) -> None:
        """Fault detection input: the caller saw this pod's process
        die. Pass the dead pod's ``incarnation`` to
        fence the removal — a successor that already re-registered under
        the same id must not lose its live lease."""
        self.store.deregister(pod_id, incarnation=incarnation)

    def reap_stale(self, timeout_s: Optional[float] = None,
                   now: Optional[float] = None,
                   return_payloads: bool = False):
        """Heartbeat-timeout sweep: deregister pods that stopped
        heartbeating without an explicit `report_dead` (host gone,
        network partition). Returns the reaped pod ids and bumps the
        ``elastic.reaped`` counter. Defaults to the store's TTL. With
        ``return_payloads=True`` returns ``(ids, {id: last_payload})`` so
        the caller can report the lost pods' final step/loss."""
        out = self.store.reap_stale(
            self.store.ttl if timeout_s is None else timeout_s, now=now,
            return_payloads=return_payloads)
        reaped = out[0] if return_payloads else out
        if reaped:
            monitor.inc("elastic.reaped", len(reaped))
        return out

    def ranks(self) -> List[str]:
        """Dense rank order over live pods (sorted pod ids -> 0..n-1),
        capped at max_nodes."""
        alive = sorted(self.store.alive())
        return alive[:self.max_nodes]

    # -- scale decisions ----------------------------------------------------
    def wait_for_world(self, deadline_s: float = 30.0
                       ) -> Optional[List[str]]:
        """Block until membership yields a trainable world (>= min_nodes),
        letting it stabilize so simultaneous joins/leaves coalesce into one
        restart. Returns the rank-ordered pod ids, or
        None if the deadline passes below min_nodes. Time flows only
        through the injected ``clock``/``sleep``, so membership tests
        drive the full wait loop with zero real sleeps."""
        return self.wait_for_quorum(self.min_nodes, deadline_s)

    def wait_for_quorum(self, min_world: int, deadline_s: float = 30.0
                        ) -> Optional[List[str]]:
        """Survivor-consensus barrier for elastic re-formation: block
        until at least ``min_world`` pods are alive (any world size at or
        above the floor is trainable — unlike :meth:`wait_for_world`,
        which insists on the manager's configured range), let membership
        stabilize so simultaneous losses/joins coalesce into ONE reform,
        and return the rank-ordered surviving world. None when the
        deadline passes still below quorum: the caller must abort (a
        world below quorum is not the one the operator asked for). Zero-sleep testable through the
        injected ``clock``/``sleep``."""
        if min_world < 1:
            raise ValueError(f"min_world must be >= 1, got {min_world}")
        end = self._clock() + deadline_s
        while True:
            pods = self.ranks()
            if len(pods) >= min_world:
                self._sleep(self.stabilize_s)  # coalesce concurrent changes
                again = self.ranks()
                if len(again) >= min_world:
                    return again
            if self._clock() >= end:
                return None
            self._sleep(0.2)

    def scale_changed(self, current: List[str]) -> Tuple[bool, List[str]]:
        """(changed?, new rank order) vs the running assignment."""
        now = self.ranks()
        return now != list(current), now
