"""Elastic membership store (the port's copy of
`paddle_tpu/distributed/elastic/store.py`).

A pod registry with TTL leases, kept as a lock-protected JSON file on a
filesystem every member can reach (one host, or a shared mount). The API
is what the elastic manager and the serving fleet need: register (with an
incarnation epoch), heartbeat, deregister, reap silent pods, and an
`alive()` snapshot that expires stale pods. Standard library only, apart
from the port's retry helper and monitor.
"""
from __future__ import annotations

import fcntl
import json
import os
import time
from typing import Dict, List, Optional

from ...framework import monitor
from ...framework.retry import retry_call

__all__ = ["MembershipStore"]


class MembershipStore:
    def __init__(self, path: str, ttl: float = 10.0,
                 lock_timeout: float = 30.0, clock=time.time):
        """``clock`` is injectable (the `framework/retry.py` pattern):
        registration, heartbeats, lease expiry and reap sweeps can run on
        ONE fake clock, so the whole detect-by-silence path tests with
        zero real sleeps."""
        self.path = path
        self.ttl = float(ttl)
        self.lock_timeout = float(lock_timeout)
        self._clock = clock
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def _locked(self, mutate):
        """Run `mutate(pods_dict) -> result` under an exclusive file
        lock; the store file is rewritten unconditionally."""
        return self._locked_rw(lambda pods: (mutate(pods), True))

    def _locked_rw(self, mutate):
        """Run `mutate(pods_dict) -> (result, changed)` under an
        exclusive file lock, rewriting the store only when ``changed``:
        the sweep paths (`reap_stale`, `alive`) run every router tick and
        usually delete nothing, and rewriting the file for a no-op would
        double the store's write traffic on a shared filesystem.

        The lock is taken non-blocking through `framework.retry` (backoff,
        deadline, `elastic.lock_retries` counter): a member wedged
        holding the lock surfaces as a timeout on its peers, not as a
        silent hang."""
        lock_path = self.path + ".lock"
        with open(lock_path, "w") as lk:
            # only EWOULDBLOCK (lock held) is transient; ENOLCK and friends
            # are permanent and must fail fast, not spin for lock_timeout
            retry_call(fcntl.flock, lk, fcntl.LOCK_EX | fcntl.LOCK_NB,
                       retries=10_000, base_delay=0.002, max_delay=0.05,
                       deadline=self.lock_timeout,
                       retry_on=(BlockingIOError,),
                       monitor_name="elastic.lock_retries")
            try:
                try:
                    with open(self.path) as f:
                        pods = json.load(f)
                except (FileNotFoundError, json.JSONDecodeError):
                    pods = {}
                result, changed = mutate(pods)
                if changed:
                    tmp = self.path + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(pods, f)
                    os.replace(tmp, self.path)
                return result
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

    def register(self, pod_id: str, endpoint: str = "",
                 payload: Optional[dict] = None) -> int:
        """Announce a pod and return its **incarnation epoch** — a per-pod-id counter that
        bumps on every registration. A re-register under the same id
        (restart, replacement replica) therefore yields a HIGHER
        incarnation than the entry it replaced, and heartbeats carrying
        the dead predecessor's incarnation are ignored (see
        :meth:`heartbeat_many`) — a zombie can no longer silently revive
        or refresh its successor's lease. ``payload`` is an arbitrary
        JSON-able load report stored alongside the lease (the fleet
        router publishes queue depth, queued cost, KV utilization)."""

        def mutate(pods):
            prev = pods.get(pod_id) or {}
            incarnation = int(prev.get("incarnation", 0)) + 1
            pods[pod_id] = {"endpoint": endpoint,
                            "last_heartbeat": self._clock(),
                            "incarnation": incarnation}
            if payload is not None:
                pods[pod_id]["payload"] = payload
            return incarnation

        return self._locked(mutate)

    def heartbeat(self, pod_id: str, incarnation: Optional[int] = None,
                  payload: Optional[dict] = None) -> bool:
        """Renew one lease; True iff applied (False = stale incarnation
        or unknown pod)."""
        stale = self.heartbeat_many(
            [pod_id],
            None if incarnation is None else {pod_id: incarnation},
            None if payload is None else {pod_id: payload})
        return pod_id not in stale

    def heartbeat_many(self, pod_ids,
                       incarnations: Optional[Dict[str, int]] = None,
                       payloads: Optional[Dict[str, dict]] = None
                       ) -> List[str]:
        """Renew several leases under ONE lock/write cycle (the fleet
        router heartbeats every live replica at once). ``incarnations``
        guards against zombies: a heartbeat whose incarnation does not
        match the registered entry's is REJECTED — it came from a dead
        pod's previous life, and applying it would keep its successor's
        entry alive on the zombie's schedule (or resurrect a reaped
        lease). A pod id absent from ``incarnations`` heartbeats
        unguarded (single-incarnation members). ``payloads``
        refreshes the per-pod load report in the same write. Returns the
        pod ids whose heartbeat was rejected as stale (also counted on
        the ``elastic.stale_heartbeats`` monitor counter)."""
        now = self._clock()

        def mutate(pods):
            stale = []
            for pid in pod_ids:
                entry = pods.get(pid)
                want = (incarnations or {}).get(pid)
                if entry is None:
                    if want is not None:
                        stale.append(pid)   # reaped/deregistered: a
                    continue                # guarded beat must NOT revive
                if want is not None \
                        and int(entry.get("incarnation", 0)) != int(want):
                    stale.append(pid)
                    continue
                entry["last_heartbeat"] = now
                if payloads and pid in payloads:
                    entry["payload"] = payloads[pid]
            return stale

        stale = self._locked(mutate)
        if stale:
            monitor.inc("elastic.stale_heartbeats", len(stale))
        return stale

    def deregister(self, pod_id: str,
                   incarnation: Optional[int] = None) -> bool:
        """Remove a pod's registration; True iff an entry was removed.
        With ``incarnation``, the removal is fenced: it only applies to
        that exact incarnation — a fenced/zombie pod deregistering
        itself cannot delete the successor that superseded its lease.
        ``None`` removes unconditionally (operator action)."""

        def mutate(pods):
            entry = pods.get(pod_id)
            if entry is None:
                return False
            if incarnation is not None \
                    and int(entry.get("incarnation", 0)) != int(incarnation):
                return False
            del pods[pod_id]
            return True

        return self._locked(mutate)

    def reap_stale(self, timeout_s: float, now: Optional[float] = None,
                   return_payloads: bool = False):
        """Deregister every pod whose last heartbeat is older than
        ``timeout_s`` and return their ids (sorted). This is the sweep a
        membership owner runs when a pod stops heartbeating without ever
        calling `deregister` — e.g. its host vanished. ``now`` is injectable so
        tests sweep deterministically with zero sleeps.

        With ``return_payloads=True`` returns ``(ids, payloads)`` where
        ``payloads`` maps each reaped pod to the last load report its
        final heartbeat carried (None if it never sent one): what a
        supervisor reports about the pods it lost."""
        t = self._clock() if now is None else float(now)

        def mutate(pods):
            stale = sorted(
                k for k, v in pods.items()
                if t - v.get("last_heartbeat", 0) > float(timeout_s))
            last = {k: pods[k].get("payload") for k in stale}
            for k in stale:
                del pods[k]
            return (stale, last), bool(stale)

        stale, last = self._locked_rw(mutate)
        return (stale, last) if return_payloads else stale

    def alive(self) -> Dict[str, dict]:
        """Live pods; entries past the TTL are expired (lease timeout)."""
        now = self._clock()

        def mutate(pods):
            dead = [k for k, v in pods.items()
                    if now - v.get("last_heartbeat", 0) > self.ttl]
            for k in dead:
                del pods[k]
            return dict(pods), bool(dead)

        return self._locked_rw(mutate)

    def clear(self) -> None:
        self._locked(lambda pods: pods.clear())
