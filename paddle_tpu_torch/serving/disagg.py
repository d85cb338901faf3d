"""Disaggregated prefill/decode serving — role-specialized replica tiers
with KV-block streaming between them (the port of
`paddle_tpu/serving/disagg.py`).

Prefill is compute-bound and bursty (one long pass per prompt), decode is
latency-bound and steady (one small step per token; TPOT is its SLO).
Colocated, a prompt storm steals whole steps from every decode lane on
the replica. Tiering splits the fleet: **prefill replicas** absorb prompt
bursts with chunked ragged prefill; **decode replicas** own sessions from
the first generated token on and never see a prompt chunk. Between them
travels the session itself — the committed KV blocks
(`inference/kv_migrate.KVBlockPayload`: bf16 / f32, or int8 with its
scale planes), the generated stream, the pending sampled token and the
sampler state — so the decode tier continues the stream bitwise with NO
re-prefill.

The handoff state machine, per session:

    PREFILLING --(final chunk committed, first token sampled)--> HANDOFF
    HANDOFF ----(extract -> release -> import on decode tier)--> DECODING

with typed failure semantics at every edge:

- extraction fails / chaos fault at ``fleet.handoff`` -> the session
  falls back to committed-prefix re-prefill relocation (the fleet's fold
  path): never lost, still terminal;
- the prefill worker DIES mid-handoff (``action="flag"`` on
  ``fleet.handoff``) -> `fail_replica` crash semantics: its pool is gone,
  every in-flight request (the one mid-handoff included) fold-relocates
  from the host-side committed stream; survivors' pools stay leak-free —
  the payload was a copy, the source's blocks died with the source, the
  target never allocated;
- every decode-capable target refuses the import (pool exhausted, queue
  full) -> fold relocation, consuming relocation budget (a clean handoff
  does NOT: the pump is routing, not failure).

The pump runs synchronously inside `step()` after the replica round: a
prefill-complete session has committed at most the tokens of that one
round before it moves, so the decode tier owns it from (in effect) token
1. Placement is role-aware end to end — `FleetRouter._targets` routes
fresh prompts to prefill-capable replicas and migrated sessions to
decode-capable ones, with the whole fleet as the fallback when a tier is
empty.
"""
from __future__ import annotations

import enum
from typing import Callable

from ..framework import monitor as _monitor
from ..resilience import faults as _faults
from .fleet import FleetHandle, FleetRouter, ReplicaHandle
from .scheduler import RequestStatus

__all__ = ["DisaggRouter", "HandoffError", "HandoffState"]


class HandoffState(enum.Enum):
    """Where a session stands in the prefill→decode migration."""
    PREFILLING = "prefilling"   # on the prefill tier, context entering
    HANDOFF = "handoff"         # extract/release/import in progress
    DECODING = "decoding"       # owned by the decode tier


class HandoffError(RuntimeError):
    """A handoff edge failed in a way the fallback could not absorb
    (programming error — load conditions and chaos faults all resolve
    to relocation or a typed terminal status, never this)."""


class DisaggRouter(FleetRouter):
    """A `FleetRouter` whose replicas are split into a prefill tier and
    a decode tier, plus the handoff pump that streams prefill-complete
    sessions (KV blocks and all) from the former to the latter.

    Drop-in: `submit`/`step`/`fleet_summary`/chaos/drain semantics are
    inherited; the only new behavior is role-aware placement (from the
    `roles=` plumbing) and `_pump_handoffs` in the step loop. A
    `DisaggRouter(num_prefill=0, num_decode=0, num_mixed=N)` is exactly
    the colocated fleet."""

    def __init__(self, engine_factory: Callable, *,
                 num_prefill: int = 1, num_decode: int = 1,
                 num_mixed: int = 0, **kwargs):
        num_prefill, num_decode = int(num_prefill), int(num_decode)
        num_mixed = int(num_mixed)
        roles = (["prefill"] * num_prefill + ["decode"] * num_decode
                 + ["mixed"] * num_mixed)
        if not roles:
            raise ValueError("DisaggRouter needs at least one replica")
        if "roles" in kwargs or "num_replicas" in kwargs:
            raise ValueError(
                "DisaggRouter derives roles/num_replicas from "
                "num_prefill/num_decode/num_mixed")
        super().__init__(engine_factory, num_replicas=len(roles),
                         roles=roles, **kwargs)

    # ---- state machine surface ----
    def handoff_state(self, fh: FleetHandle) -> HandoffState:
        """The session's current migration state (PREFILLING until its
        final context chunk commits, DECODING once a decode-capable
        replica owns it)."""
        return getattr(fh, "_handoff_state", HandoffState.PREFILLING)

    # ---- driving ----
    def step(self) -> int:
        produced = super().step()
        self._pump_handoffs()
        # the pump can terminalize handles (budget exhausted on a fold
        # fallback) after the inherited prune already ran this round
        self._handles = [fh for fh in self._handles
                         if not fh._req.status.terminal]
        return produced

    def _pump_handoffs(self) -> int:
        """Move every prefill-complete session off the prefill tier.
        Returns handoffs landed this round (fold fallbacks excluded)."""
        moved = 0
        for src in [r for r in self._replicas
                    if r.alive and not r.draining and r.role == "prefill"]:
            ready = [fh for fh in self._handles
                     if fh._replica is src
                     and not fh._req.status.terminal
                     and fh._req.status is RequestStatus.RUNNING
                     and not fh._req.prefilling
                     and fh._req.generated]
            for fh in ready:
                if self._handoff_one(src, fh):
                    moved += 1
                if not src.alive:
                    break               # chaos killed the source mid-pump
        return moved

    def _handoff_one(self, src: ReplicaHandle, fh: FleetHandle) -> bool:
        """One PREFILLING -> HANDOFF -> DECODING transition; every
        failure edge lands in relocation (fold) or crash semantics."""
        req = fh._req
        fh._handoff_state = HandoffState.HANDOFF
        t0 = self._clock()
        payload = None
        try:
            # ONE counted call at the chaos site: a raise-action rule
            # fails the extraction edge, a flag-action rule kills the
            # prefill worker mid-handoff
            if _faults.check_flag("fleet.handoff"):
                # crash semantics for the WHOLE source replica: its pool
                # (and any just-extracted payload's source) is gone;
                # fail_replica fold-relocates every victim, this session
                # included, from the host-side committed streams
                _monitor.inc("fleet.handoff_faults")
                self.fail_replica(src.replica_id,
                                  reason="handoff_chaos_kill")
                return False
            payload = self._extract_payload(src, req)
        except Exception:
            # extraction edge failed (chaos raise / engine fault):
            # fall through to the fold fallback below
            _monitor.inc("fleet.handoff_faults")
        src.frontend.release(req)
        placed = False
        if payload is not None:
            req.status = RequestStatus.QUEUED
            req.finish_reason = None
            placed = self._place_session(fh, payload, exclude={src})
        if placed:
            fh._handoff_state = HandoffState.DECODING
            _monitor.inc("fleet.handoffs")
            wall = self._clock() - t0
            target = fh._replica
            target.frontend.metrics.on_handoff(payload.nbytes, wall)
            return True
        # import refused everywhere (or extraction failed): committed
        # -prefix re-prefill relocation — consumes relocation budget,
        # keeps the every-request-terminal contract. live_source=False:
        # the release above already freed the source blocks.
        _monitor.inc("fleet.handoff_fallbacks")
        fh._handoff_state = HandoffState.PREFILLING
        self._relocate(fh, reason="handoff_fallback", live_source=False)
        if not req.status.terminal and fh._replica is not None \
                and fh._replica.role == "decode":
            # the fold landed on a decode-capable replica after all —
            # it re-prefills there, then owns the stream
            fh._handoff_state = HandoffState.DECODING
        return False

    # ---- summary ----
    def fleet_summary(self) -> dict:
        out = super().fleet_summary()
        out["tiers"] = {
            "prefill": [r.replica_id for r in self._replicas
                        if r.role == "prefill" and r.alive],
            "decode": [r.replica_id for r in self._replicas
                       if r.role == "decode" and r.alive],
            "mixed": [r.replica_id for r in self._replicas
                      if r.role == "mixed" and r.alive],
        }
        return out
