"""FleetRouter — a data-parallel serving tier over N `ServingFrontend`
replicas (the port of `paddle_tpu/serving/fleet.py`).

One frontend is one failure domain and one card's worth of traffic; the
router puts N identical replicas behind load-aware dispatch, with
membership, failure and scale-out semantics that extend the frontend's
contract fleet-wide:

    every request submitted to the FLEET reaches a terminal status,
    even when the replica serving it dies mid-decode.

- **Membership** rides the elastic layer (`distributed/elastic`): each
  replica registers as a pod in a `MembershipStore` and heartbeats with a
  LOAD PAYLOAD (queue depth, queued cost, KV utilization, prefix hit
  rate, resident adapters). Registrations carry an **incarnation
  epoch**, so a dead replica's zombie heartbeats never revive its
  successor's lease; `reap_stale` (the router's periodic membership
  sweep) declares silent replicas dead, and a replica whose own
  heartbeat comes back stale fences itself (`lease_lost`).

- **Load-aware, session-affine dispatch**: placement picks the
  least-loaded live replica by a queue-depth + queued-cost + KV-pressure
  score; a request with a `session_id` sticks to the replica that served
  the session last (where its cache is), and a request on a LoRA adapter
  prefers replicas where the adapter is resident. Requests shed or
  queue-rejected by one replica retry on the next-best replica before
  SHED surfaces.

- **Replica failure**: when a replica dies (chaos kill, membership
  reaped, a step that raises, or replica-internal
  `engine_unrecoverable:*` collapse), every in-flight request it held is
  relocated to a survivor with its committed tokens folded into the
  prompt: the preemption invariant (tokens so far intact, re-prefill
  token-deterministic) across replicas, so a relocated greedy request's
  stream is bitwise what an unkilled run produces, where the engine's
  steps are batch-invariant. A live source (a drain) ships the committed
  KV blocks instead (`inference/kv_migrate.py`) and the survivor decodes
  on with no re-prefill. Each request has a relocation BUDGET; past it
  the request fails typed (`relocation_budget_exhausted`).

- **Elastic scale-out**: `add_replica` joins a new replica (fresh
  incarnation); `drain_replica` retires one gracefully — stop placing,
  relocate (or finish) its in-flight work, deregister once idle.

- **One surface**: `fleet_summary()` aggregates per-replica snapshots
  through `monitor.aggregate_mesh` (summed load and throughput, the
  straggler replica from per-replica step walls).

Chaos sites (`resilience.faults`): ``fleet.step`` (per router step;
``action="flag"`` kills the busiest live replica) and ``fleet.submit``
(per placement attempt; a raise models an unreachable replica and drives
the failover path).

Single-process: replicas are in-process frontends (one per card in a
deployment); `parallel=True` steps them from a thread pool so their
device work overlaps. The router itself is driven from ONE thread; only
`step()`'s per-replica fan-out is concurrent.
"""
from __future__ import annotations

import itertools
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from .. import observability as _obs
from ..distributed.elastic import ElasticManager, MembershipStore
from ..framework import monitor as _monitor
from ..observability import timeline as _timeline
from ..resilience import faults as _faults
from .frontend import RequestHandle, ServingFrontend
from .scheduler import Request, RequestStatus, SamplingParams

__all__ = ["FleetHandle", "FleetRouter", "ReplicaHandle"]

# structural rejections are identical on every (homogeneous) replica —
# retrying them elsewhere only wastes a placement attempt
_NO_RETRY_REASONS = ("empty_prompt", "prompt_too_long")
_UNRECOVERABLE_PREFIXES = ("engine_unrecoverable", "engine_rebuild_failed")
# session-affinity map bound (LRU-evicted in `_note_session`): affinity
# is advisory, so eviction only costs one least-loaded placement
_SESSION_CAP = 65536
# disaggregated serving roles (serving/disagg.py): "prefill" replicas take
# fresh prompts, "decode" replicas take migrated-KV sessions, "mixed"
# takes both; role filters are preferences — an empty tier falls back to
# the whole fleet (availability beats specialization)
_REPLICA_ROLES = {"prefill", "decode", "mixed"}


class ReplicaHandle:
    """One serving replica: a `ServingFrontend` plus its membership
    lease (pod id == replica id, incarnation epoch) and per-replica
    accounting the router's placement score and fleet aggregation read."""

    def __init__(self, replica_id: str, frontend: ServingFrontend,
                 incarnation: int, role: str = "mixed"):
        self.replica_id = replica_id
        self.frontend = frontend
        self.incarnation = incarnation
        # disaggregated serving: "prefill" replicas take
        # fresh prompts and hand completed sessions off; "decode"
        # replicas take migrated sessions; "mixed" takes both (the
        # pre-disaggregation fleet is all-mixed)
        self.role = role
        self.alive = True
        self.draining = False
        self.death_reason: Optional[str] = None
        self.steps = 0
        self.last_step_wall_ms = 0.0

    @property
    def scheduler(self):
        return self.frontend.scheduler

    @property
    def tokens_produced(self) -> int:
        """Tokens this replica committed to request streams over its
        lifetime (`Scheduler.tokens_committed` — frozen at its last
        value once the replica dies)."""
        return self.frontend.scheduler.tokens_committed

    def load(self) -> dict:
        """The live load snapshot: placement input AND the heartbeat
        payload published to the membership store. `prefix_hit_rate` is
        the replica's OWN radix-cache hit rate (0.0 with the cache off)
        — advisory evidence that a session's radix path lives here, so
        session-affine dispatch keeps landing its turns where the KV
        already is."""
        s = self.frontend.scheduler
        pstats = s.prefix_stats()
        pool = getattr(s.engine, "adapter_pool", None)
        return {
            "queue_depth": len(s.waiting),
            "running": s.num_running,
            "queued_cost": s._queued_cost,
            "kv_utilization": round(s.engine.manager.utilization(), 4),
            "tokens_generated": self.tokens_produced,
            "prefix_hit_rate": (pstats["hit_rate"] if pstats else 0.0),
            "prefix_cached_blocks": (pstats["nodes"] if pstats else 0),
            # multi-LoRA (serving/lora.py): which adapters are HOT here:
            # the router's adapter-affinity evidence (a request landing
            # where its adapter is resident admits without a pool load)
            "resident_adapters": (pool.resident_names() if pool else []),
        }

    def __repr__(self):
        state = ("draining" if self.draining and self.alive else
                 "alive" if self.alive else
                 self.death_reason or "dead")
        return (f"ReplicaHandle({self.replica_id}, {state}, "
                f"role={self.role}, inc={self.incarnation}, "
                f"tokens={self.tokens_produced})")


class FleetHandle(RequestHandle):
    """Caller's view of one FLEET request: a `RequestHandle` whose token
    stream spans replica relocations — `tokens` is the committed prefix
    carried from previous placements plus what the current replica has
    generated. `replica_id`/`num_relocations` (inherited) report where
    it lives and how often it moved."""

    def __init__(self, req: Request, max_new_total: int,
                 session_id: Optional[str]):
        super().__init__(req)
        self._replica: Optional[ReplicaHandle] = None
        self._prefix: List[int] = []
        self.max_new_total = int(max_new_total)
        self.session_id = session_id

    @property
    def tokens(self) -> List[int]:
        return self._prefix + list(self._req.generated)

    def __repr__(self):
        return (f"FleetHandle(id={self.request_id}, "
                f"status={self.status.value}, replica={self.replica_id}, "
                f"tokens={len(self._prefix) + len(self._req.generated)}, "
                f"relocations={self.num_relocations}, "
                f"reason={self.finish_reason})")


class FleetRouter:
    def __init__(self, engine_factory: Callable, num_replicas: int = 2, *,
                 store: Optional[MembershipStore] = None,
                 membership_ttl_s: float = 10.0,
                 heartbeat_every: int = 8,
                 sweep_every: int = 32,
                 relocation_budget: int = 2,
                 submit_retries: int = 1,
                 kv_pressure_weight: float = 8.0,
                 parallel: bool = False,
                 prefix_streaming: bool = True,
                 frontend_kwargs: Optional[dict] = None,
                 roles: Optional[Sequence[str]] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 wall_clock: Callable[[], float] = time.time):
        """`engine_factory` builds ONE replica's engine (called once per
        replica; identical seeds across replicas make relocation replay
        bitwise for greedy requests). `store`: a `MembershipStore`; when
        None a private temp-file store is created (single-process
        fleet). `heartbeat_every`/`sweep_every`: router steps between
        heartbeat writes and membership sweeps (`reap_stale` + lost-pod
        detection) — file I/O stays off the per-step hot path.
        `relocation_budget`: max replica moves per request before it
        fails typed. `submit_retries`: extra replicas tried when one
        sheds/queue-rejects a submission. `kv_pressure_weight`: how many
        queued requests one full KV pool is "worth" in the placement
        score. `parallel`: step replicas from a thread pool (throughput);
        sequential stepping is deterministic (tests/chaos).
        `frontend_kwargs` forwards to every `ServingFrontend` (spec,
        admission, watchdog, prefill_chunk_tokens, ...); unless
        overridden there, each replica gets `engine_factory` as its
        watchdog rebuild hook, so replica-internal restarts happen
        below the router and only *unrecoverable* collapse escalates to
        relocation. `roles`: per-replica serving roles for disaggregated
        prefill/decode (`"prefill"` | `"decode"` | `"mixed"`, one per
        replica; default all-mixed — the colocated fleet). Role-aware
        placement routes fresh prompts to prefill-capable replicas and
        migrated KV sessions to decode-capable ones; see
        `serving/disagg.py` for the handoff pump that moves sessions
        between the tiers. `prefix_streaming`: when replicas run the
        radix prefix cache (`frontend_kwargs=dict(prefix_cache=True)`),
        an admission-time first-miss on one replica pulls the prefix KV
        from the best-matching live peer over the migration primitive
        (cross-replica prefix reuse) — best-effort, every failure falls
        back to a cold prefill. Inline streams are wired only under
        sequential stepping: with `parallel=True` the hook would reach
        into a peer's engine from another worker thread mid-round, so
        it is left unset. `wall_clock` feeds membership TTLs
        (injectable: zero-sleep reap tests); `clock` feeds latency
        accounting."""
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1: {num_replicas}")
        if roles is not None:
            roles = [str(r) for r in roles]
            if len(roles) != num_replicas:
                raise ValueError(
                    f"roles must name every replica: got {len(roles)} "
                    f"roles for num_replicas={num_replicas}")
            bad = sorted(set(roles) - _REPLICA_ROLES)
            if bad:
                raise ValueError(
                    f"unknown replica role(s) {bad}; "
                    f"valid: {sorted(_REPLICA_ROLES)}")
        self.engine_factory = engine_factory
        self.relocation_budget = int(relocation_budget)
        self.submit_retries = int(submit_retries)
        self.kv_pressure_weight = float(kv_pressure_weight)
        self.heartbeat_every = max(1, int(heartbeat_every))
        self.sweep_every = max(1, int(sweep_every))
        self.frontend_kwargs = dict(frontend_kwargs or {})
        self._parallel = bool(parallel)
        self._prefix_streaming = bool(prefix_streaming) and not parallel
        self._pool = None
        self._clock = clock
        self._wall = wall_clock
        self._own_store_path = None
        if store is None:
            fd, path = tempfile.mkstemp(prefix="ptpu_fleet_",
                                        suffix=".json")
            os.close(fd)
            self._own_store_path = path
            store = MembershipStore(path, ttl=membership_ttl_s)
        self.store = store
        self.manager = ElasticManager(store, min_nodes=1,
                                      max_nodes=max(num_replicas, 64))
        self._rep_ids = itertools.count()
        self._replicas: List[ReplicaHandle] = []
        self._sessions: Dict[str, str] = {}     # session_id -> replica_id
        self._handles: List[FleetHandle] = []   # non-terminal fleet reqs
        self._step_idx = 0
        for i in range(num_replicas):
            self._spawn(engine_factory,
                        role=roles[i] if roles is not None else "mixed")
        self._publish_gauges()

    # ---- membership / replica lifecycle ----
    def _spawn(self, factory: Callable,
               role: str = "mixed") -> ReplicaHandle:
        rid = f"replica-{next(self._rep_ids)}"
        kw = dict(self.frontend_kwargs)
        kw.setdefault("engine_factory", factory)
        fe = ServingFrontend(factory(), clock=self._clock, **kw)
        rep = ReplicaHandle(rid, fe, incarnation=0, role=role)
        if self._prefix_streaming \
                and fe.scheduler.prefix_cache is not None:
            fe.scheduler.prefix_stream_hook = \
                lambda toks, _rep=rep: self._stream_prefix_to(_rep, toks)
        rep.incarnation = self.manager.register(rid, payload=rep.load())
        self._replicas.append(rep)
        return rep

    def add_replica(self, engine_factory: Optional[Callable] = None,
                    role: str = "mixed") -> str:
        """Elastic scale-out: join one fresh replica (new pod id, fresh
        incarnation) and start placing onto it immediately. Returns the
        replica id."""
        if role not in _REPLICA_ROLES:
            raise ValueError(f"unknown replica role {role!r}; "
                             f"valid: {sorted(_REPLICA_ROLES)}")
        rep = self._spawn(engine_factory or self.engine_factory, role=role)
        _monitor.inc("fleet.replicas_added")
        self._publish_gauges()
        return rep.replica_id

    def drain_replica(self, replica_id: str, relocate: bool = True) -> None:
        """Graceful retirement: stop placing onto the replica, then
        either relocate its in-flight requests to survivors now
        (`relocate=True`; committed tokens carried, same budget as
        failure relocation — an over-budget request finishes in place)
        or let them finish where they run. Once its scheduler drains
        idle the replica deregisters (`step()` completes the
        lifecycle)."""
        rep = self._rep(replica_id)
        if rep is None or not rep.alive or rep.draining:
            return
        rep.draining = True
        _monitor.inc("fleet.drains")
        if relocate:
            for fh in [fh for fh in self._handles
                       if fh._replica is rep
                       and not fh._req.status.terminal]:
                if fh._req.num_relocations >= self.relocation_budget:
                    continue            # over budget: finish in place
                self._relocate(fh, reason="drain", live_source=True)
        self._publish_gauges()

    def fail_replica(self, replica_id: str,
                     reason: str = "killed") -> List[FleetHandle]:
        """Declare one replica DEAD (crash semantics: its engine/KV state
        is lost; only the host-side committed token streams survive) and
        relocate every request it held to survivors. Idempotent; returns
        the relocated/terminalized handles."""
        rep = self._rep(replica_id)
        if rep is None or not rep.alive:
            return []
        rep.alive = False
        rep.draining = False
        rep.death_reason = reason
        _monitor.inc("fleet.replica_deaths")
        try:
            # fenced removal: a replica fenced for `lease_lost` must not
            # delete the SUCCESSOR that superseded its incarnation
            self.store.deregister(replica_id, incarnation=rep.incarnation)
        except Exception:
            pass                        # membership may already be gone
        if _obs.enabled():
            _timeline.dispatch_span(
                f"fleet.replica_dead:{replica_id}", self._clock(), None,
                reason=reason)
        victims = [fh for fh in self._handles if fh._replica is rep
                   and (not fh._req.status.terminal
                        or (fh._req.finish_reason or "").startswith(
                            _UNRECOVERABLE_PREFIXES))]
        for fh in victims:
            self._relocate(fh, reason=f"replica_dead:{reason}",
                           live_source=False)
        self._publish_gauges()
        return victims

    def chaos_kill_replica(self) -> Optional[str]:
        """Kill the BUSIEST live replica (most running + queued;
        deterministic tie-break by replica order) — what the armed
        ``fleet.step`` chaos site does mid-burst."""
        live = [r for r in self._replicas if r.alive]
        if not live:
            return None
        rep = max(live, key=lambda r: (r.scheduler.num_running
                                       + len(r.scheduler.waiting),
                                       -self._replicas.index(r)))
        _monitor.inc("fleet.chaos_kills")
        self.fail_replica(rep.replica_id, reason="chaos_kill")
        return rep.replica_id

    def _rep(self, replica_id: str) -> Optional[ReplicaHandle]:
        for rep in self._replicas:
            if rep.replica_id == replica_id:
                return rep
        return None

    @property
    def replicas(self) -> List[ReplicaHandle]:
        return list(self._replicas)

    @property
    def live_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self._replicas if r.alive]

    # ---- placement ----
    def _score(self, rep: ReplicaHandle) -> float:
        """Least-loaded placement score (lower = preferred): requests in
        the system, plus queued decode cost normalized per lane, plus KV
        pressure weighted as `kv_pressure_weight` queued requests for a
        full pool."""
        s = rep.frontend.scheduler
        lanes = max(1, len(s.slots))
        return ((s.num_running + len(s.waiting))
                + s._queued_cost / (16.0 * lanes)
                + self.kv_pressure_weight
                * s.engine.manager.utilization())

    def _targets(self, session_id: Optional[str],
                 exclude: Set[ReplicaHandle],
                 phase: Optional[str] = None,
                 adapter: Optional[str] = None) -> List[ReplicaHandle]:
        """Ordered placement candidates. `phase` names the work being
        placed — "prefill" (a fresh/folded prompt) prefers
        prefill-capable replicas, "decode" (a migrated-KV session)
        prefers decode-capable ones; mixed replicas serve both. The
        role filter is a preference, not a fence: when the wanted tier
        has no placeable replica (all dead/draining), the whole fleet
        is eligible — availability beats specialization. `adapter`
        front-moves replicas whose adapter pool already holds the
        request's LoRA adapter (resident = admission without a priced
        pool load — the same advisory affinity as sessions; session
        affinity, applied after, still wins)."""
        placeable = [r for r in self._replicas
                     if r.alive and not r.draining and r not in exclude]
        if phase is not None:
            tiered = [r for r in placeable
                      if r.role == phase or r.role == "mixed"]
            if tiered:
                placeable = tiered
        placeable.sort(key=lambda r: (self._score(r),
                                      self._replicas.index(r)))
        if adapter is not None:
            def _hot(rep):
                pool = getattr(rep.frontend.scheduler.engine,
                               "adapter_pool", None)
                try:
                    return pool is not None and pool.is_resident(adapter)
                except Exception:
                    return False
            placeable.sort(key=lambda r: 0 if _hot(r) else 1)
        if session_id is not None:
            home = self._rep(self._sessions.get(session_id, ""))
            if home is not None and home in placeable:
                placeable.remove(home)
                placeable.insert(0, home)   # session affinity wins ties
        return placeable

    # ---- request API ----
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               eos_token_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               stream_cb=None, seed: int = 0,
               session_id: Optional[str] = None,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None) -> FleetHandle:
        """`ServingFrontend.submit` fleet-wide: place on the session's
        home replica (when `session_id` is given and its replica lives)
        or the least-loaded replica; a shed/queue-full answer retries on
        the next-best replica (`submit_retries`) before surfacing. NEVER
        raises on load conditions — the returned handle is terminal with
        a reason when the fleet cannot take the request."""
        now = self._clock()
        if timeout_s is None:
            # honor the fleet-wide default deadline the way a standalone
            # frontend would (frontend.submit is bypassed here — the
            # router owns placement, so it builds the Request itself)
            timeout_s = self.frontend_kwargs.get("default_timeout_s")
        sp = SamplingParams(max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_token_id=eos_token_id, seed=seed)
        cb = None
        if stream_cb is not None:
            cb = lambda req, tok, _cb=stream_cb: _cb(tok)  # noqa: E731
        if adapter is not None and tenant is None:
            # tenant = adapter when any replica's SLO config carries a
            # class by that name (the frontend.submit mapping, fleet-wide
            # — configs are deployed uniformly, so first-live suffices)
            for rep in self.live_replicas:
                slo = rep.frontend.scheduler._slo
                if slo is not None and adapter in slo.classes:
                    tenant = adapter
                    break
        req = Request(prompt_ids, sampling=sp,
                      deadline=None if timeout_s is None
                      else now + timeout_s, stream_cb=cb, tenant=tenant,
                      adapter=adapter)
        req.session_id = session_id
        fh = FleetHandle(req, max_new_tokens, session_id)
        _monitor.inc("fleet.submitted")
        self._place_request(fh, exclude=set())
        if not req.status.terminal:
            self._handles.append(fh)
        return fh

    def cancel(self, handle: FleetHandle) -> bool:
        rep = handle._replica
        if rep is None:
            return False
        return rep.frontend.cancel(handle)

    def _place_request(self, fh: FleetHandle,
                       exclude: Set[ReplicaHandle]) -> bool:
        """Try the ordered target list until one replica accepts. A
        ``fleet.submit`` fault (unreachable replica) fails over without
        consuming a retry; a shed/queue_full answer consumes one.
        Returns True when placed; on False the request is terminal
        (last shed reason, a structural rejection, or
        `no_replica_available`)."""
        req = fh._req
        attempts_left = self.submit_retries + 1
        for rep in self._targets(fh.session_id, exclude, phase="prefill",
                                 adapter=req.adapter):
            if attempts_left <= 0:
                break
            try:
                _faults.check("fleet.submit")
            except Exception:
                _monitor.inc("fleet.submit_faults")
                continue
            attempts_left -= 1
            if req.status.terminal:     # reset a prior shed for retry
                req.status = RequestStatus.QUEUED
                req.finish_reason = None
            req.replica_id = rep.replica_id
            rep.frontend.resubmit(req)
            if not req.status.terminal:
                fh._replica = rep
                self._note_session(fh.session_id, rep.replica_id)
                return True
            if req.finish_reason in _NO_RETRY_REASONS:
                return False
            _monitor.inc("fleet.retried_submits")
        if not req.status.terminal:
            # every placement attempt faulted before reaching admission
            self._terminal(fh, RequestStatus.FAILED,
                           "no_replica_available")
        return False

    def _place_session(self, fh: FleetHandle, payload,
                       exclude: Set[ReplicaHandle]) -> bool:
        """Place a request WITH its migrated KV
        (`ServingFrontend.import_session`): decode-capable targets
        first, session affinity intact. A typed migration/capacity
        refusal (pool exhausted on that target, geometry mismatch, an
        engine without the primitive) moves to the next candidate
        without consuming a retry — those are per-target conditions,
        unlike a shed. Returns True when some replica owns the session;
        on False the request is left for the caller's re-prefill
        fallback (non-terminal, or terminal-rejected on a structural
        reason)."""
        req = fh._req
        attempts_left = self.submit_retries + 1
        for rep in self._targets(fh.session_id, exclude, phase="decode",
                                 adapter=req.adapter):
            if attempts_left <= 0:
                break
            try:
                _faults.check("fleet.submit")
            except Exception:
                _monitor.inc("fleet.submit_faults")
                continue
            if req.status.terminal:     # reset a prior shed for retry
                req.status = RequestStatus.QUEUED
                req.finish_reason = None
            req.replica_id = rep.replica_id
            try:
                rep.frontend.import_session(req, payload)
            except Exception:
                _monitor.inc("fleet.kv_import_failures")
                continue
            attempts_left -= 1
            if not req.status.terminal:
                fh._replica = rep
                self._note_session(fh.session_id, rep.replica_id)
                return True
            if req.finish_reason in _NO_RETRY_REASONS:
                return False
            _monitor.inc("fleet.retried_submits")
        return False

    def _note_session(self, session_id: Optional[str], replica_id: str):
        if session_id is None:
            return
        prev = self._sessions.pop(session_id, None)   # pop+set: LRU order
        if prev == replica_id:
            _monitor.inc("fleet.session_hits")
        elif prev is not None:
            _monitor.inc("fleet.session_misses")
        self._sessions[session_id] = replica_id
        # bounded affinity map: a long-lived router serving many unique
        # sessions must not grow this dict forever (entries are advisory
        # — evicting one just means the next turn places least-loaded);
        # dict insertion order + the pop above make this LRU eviction
        while len(self._sessions) > _SESSION_CAP:
            self._sessions.pop(next(iter(self._sessions)))

    def _terminal(self, fh: FleetHandle, status: RequestStatus,
                  reason: str):
        req = fh._req
        req.status = status
        req.finish_reason = reason
        req.t_finish = self._clock()
        if status is RequestStatus.FAILED:
            _monitor.inc("fleet.requests_failed")
            _monitor.inc(f"fleet.requests_failed.{reason}")
        if _obs.enabled():
            _timeline.request_event(
                req.req_id, f"terminal:{status.value}", req.t_finish,
                reason=reason)

    # ---- relocation (the fleet failure semantics) ----
    def _extract_payload(self, src: ReplicaHandle, req: Request):
        """Best-effort KV export from a still-live source replica.
        Returns a `KVBlockPayload` or None (engine without the
        primitive, no resident blocks, or an extraction fault) — None
        just means the relocation re-prefills."""
        try:
            eng = src.frontend.scheduler.engine
            extract = getattr(eng, "extract_kv_blocks", None)
            if extract is None:
                return None
            if eng.manager.seq_blocks(req.seq_id) <= 0:
                return None
            return extract(req.seq_id)
        except Exception:
            _monitor.inc("fleet.kv_ship_failures")
            return None

    def _stream_prefix_to(self, rep: ReplicaHandle, tokens) -> None:
        """Cross-replica prefix reuse: `rep`'s scheduler hit
        an admission-time radix FIRST-MISS on `tokens` — pull the
        longest full-block cached prefix from the best-matching live
        peer over the migration primitive and publish it into `rep`'s
        tree, so the lease that follows hits locally and the prefill is
        skipped. Best-effort by contract: every failure is counted
        (`fleet.prefix_stream_failures`) and swallowed — a failed
        stream means a cold prefill, never a failed request."""
        tgt = rep.frontend.scheduler
        best, best_hit = None, 0
        for peer in self.live_replicas:
            if peer is rep:
                continue
            tree = peer.frontend.scheduler.prefix_cache
            if tree is None:
                continue
            try:
                _blocks, hit = tree.match_export(tokens)
            except Exception:
                continue
            if hit > best_hit:
                best, best_hit = peer, hit
        if best is None:
            return
        try:
            payload = best.frontend.scheduler.export_prefix(tokens)
            gained = (0 if payload is None
                      else tgt.import_prefix(tokens, payload))
        except Exception:
            _monitor.inc("fleet.prefix_stream_failures")
            return
        if gained:
            _monitor.inc("fleet.prefix_streams")
            _monitor.inc("fleet.prefix_stream_tokens", gained)
            _monitor.inc("fleet.prefix_stream_bytes", payload.nbytes)

    def _relocate(self, fh: FleetHandle, reason: str,
                  live_source: bool) -> None:
        """Move one request to a survivor, committed tokens intact.

        Two paths:

        - **KV shipping** (source live and reachable — drain, overload,
          handoff fallback): the committed KV blocks are extracted from
          the source pool BEFORE release frees them and injected into
          the target (`import_session`), so the target decodes from the
          next token with NO re-prefill. The generated stream, pending
          sampled token, and sampling state ride along untouched —
          greedy continuation is bitwise the unmoved run's.
        - **Committed-prefix re-prefill** (dead source, or shipping
          refused everywhere): the generated stream so far folds into
          the prompt and the target re-prefills — token-deterministic,
          the preemption invariant across replicas.

        Both paths shrink the remaining budget by what is already
        committed, and the relocation budget bounds how often a request
        may move. `live_source` releases cleanly from a still-running
        replica (drain); a dead source's scheduler — and pool — is
        never touched."""
        req = fh._req
        src = fh._replica
        payload = None
        if live_source and src is not None and src.alive \
                and not req.status.terminal:
            # extract BEFORE release: release frees the source blocks
            payload = self._extract_payload(src, req)
        if live_source and src is not None:
            src.frontend.release(req)
        carried = list(req.generated)
        remaining = fh.max_new_total - (len(fh._prefix) + len(carried))
        if remaining <= 0:
            # everything the caller asked for is already committed — the
            # relocation IS the finish (eos'd requests are terminal
            # before ever reaching here)
            fh._prefix.extend(carried)
            self._terminal(fh, RequestStatus.FINISHED, "max_new_tokens")
            return
        if req.num_relocations >= self.relocation_budget:
            fh._prefix.extend(carried)
            self._terminal(fh, RequestStatus.FAILED,
                           "relocation_budget_exhausted")
            return
        req.num_relocations += 1
        _monitor.inc("fleet.relocations")
        _monitor.inc("fleet.relocated_tokens", len(carried))
        if _obs.enabled():
            _timeline.request_event(
                req.req_id, "relocated", self._clock(),
                from_replica=src.replica_id if src else None,
                reason=reason, tokens_carried=len(carried),
                relocations=req.num_relocations,
                shipped_kv=payload is not None)
        t_submit0 = req.t_submit
        placed = False
        if payload is not None:
            # KV-shipping path: generated/_last/sampling stay in place —
            # the target picks up mid-stream from the migrated blocks
            req.status = RequestStatus.QUEUED
            req.finish_reason = None
            placed = self._place_session(
                fh, payload, exclude={src} if src else set())
            if placed:
                _monitor.inc("fleet.relocations_shipped")
                _monitor.inc("fleet.shipped_kv_bytes",
                             int(payload.nbytes))
        if not placed:
            # re-prefill fallback (and the pre-shipping default): fold
            # committed tokens into the prompt and resubmit
            fh._prefix.extend(carried)
            if carried:
                req.prompt = np.concatenate(
                    [req.prompt,
                     np.asarray(carried, np.int32)]).astype(np.int32)
            req.generated = []
            req._last = None
            req.sampling.max_new_tokens = remaining
            req.status = RequestStatus.QUEUED
            req.finish_reason = None
            placed = self._place_request(
                fh, exclude={src} if src else set())
        if not placed and live_source and src is not None and src.alive:
            # drain fallback: no survivor took it (none placeable, or
            # every one shed) — finish in place on the still-live
            # draining source instead of losing admitted work to a
            # terminal SHED/no_replica_available
            req.status = RequestStatus.QUEUED
            req.finish_reason = None
            req.replica_id = src.replica_id
            src.frontend.resubmit(req)
            if not req.status.terminal:
                fh._replica = src
        if t_submit0 is not None:
            # fleet latency accounting spans relocations: TTFT/queue-wait
            # measure from the ORIGINAL submission, not the re-placement
            req.t_submit = t_submit0

    # ---- driving ----
    def step(self) -> int:
        """One fleet round: advance every live replica one scheduling
        step (threaded under `parallel=True`), then run the control
        plane — escalate replica-internal collapse to relocation,
        heartbeat with load payloads, sweep membership, complete drains.
        Returns decode tokens produced fleet-wide this round."""
        self._step_idx += 1
        if _faults.check_flag("fleet.step"):
            self.chaos_kill_replica()
        stepped = [r for r in self._replicas
                   if r.alive and not r.frontend.scheduler.idle]
        produced = 0
        raised: List[ReplicaHandle] = []
        if self._parallel and len(stepped) > 1:
            futs = [(rep, self._executor().submit(self._step_replica, rep))
                    for rep in stepped]
            for rep, fut in futs:
                try:
                    produced += fut.result()
                except Exception:
                    raised.append(rep)
        else:
            for rep in stepped:
                try:
                    produced += self._step_replica(rep)
                except Exception:
                    raised.append(rep)
        for rep in raised:
            # a step that escapes the frontend's own fault machinery is
            # a dead replica, not a dead fleet
            self.fail_replica(rep.replica_id, reason="step_raised")
        self._escalate_unrecoverable()
        if self._step_idx % self.heartbeat_every == 0:
            self._heartbeat()
        if self._step_idx % self.sweep_every == 0:
            self.sweep_membership()
        self._finish_drains()
        self._handles = [fh for fh in self._handles
                         if not fh._req.status.terminal]
        return produced

    def _step_replica(self, rep: ReplicaHandle) -> int:
        t0 = self._clock()
        n = rep.frontend.step()
        rep.last_step_wall_ms = (self._clock() - t0) * 1e3
        rep.steps += 1
        return n

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="fleet-step")
        return self._pool

    def _escalate_unrecoverable(self):
        """A replica that failed requests `engine_unrecoverable:*` (its
        watchdog budget is gone) or broke mid-rebuild cannot serve — the
        FLEET can: declare it dead and relocate, resetting those typed
        failures back to queued work on survivors."""
        sick: List[str] = []
        for fh in self._handles:
            reason = fh._req.finish_reason or ""
            if fh._req.status is RequestStatus.FAILED \
                    and reason.startswith(_UNRECOVERABLE_PREFIXES) \
                    and fh._replica is not None and fh._replica.alive:
                if fh._replica.replica_id not in sick:
                    sick.append(fh._replica.replica_id)
        for rid in sick:
            self.fail_replica(rid, reason="engine_unrecoverable")

    def _heartbeat(self):
        live = [r for r in self._replicas if r.alive]
        if not live:
            return
        stale = self.manager.heartbeat_many(
            [r.replica_id for r in live],
            incarnations={r.replica_id: r.incarnation for r in live},
            payloads={r.replica_id: r.load() for r in live})
        for rid in stale:
            # our lease was superseded (a newer incarnation registered
            # under this id) or reaped: fence this replica rather than
            # serve split-brain
            self.fail_replica(rid, reason="lease_lost")

    def sweep_membership(self) -> List[str]:
        """Reap silent pods and reconcile: any of OUR replicas whose
        membership entry is gone (reaped by TTL, deregistered by an
        operator) is declared dead and its work relocated. Runs every
        `sweep_every` steps; callable directly for deterministic
        tests."""
        reaped = list(self.manager.reap_stale(now=self._wall()))
        alive_pods = self.store.alive()
        lost = [r.replica_id for r in self._replicas
                if r.alive and r.replica_id not in alive_pods]
        for rid in lost:
            self.fail_replica(rid, reason="membership_reaped"
                              if rid in reaped else "membership_lost")
        return lost

    def _finish_drains(self):
        for rep in self._replicas:
            if rep.alive and rep.draining and rep.frontend.scheduler.idle:
                rep.alive = False
                rep.death_reason = "drained"
                _monitor.inc("fleet.drained")
                try:
                    self.store.deregister(rep.replica_id,
                                          incarnation=rep.incarnation)
                except Exception:
                    pass
                self._publish_gauges()

    @property
    def idle(self) -> bool:
        return all(r.frontend.scheduler.idle for r in self._replicas
                   if r.alive)

    def run_until_idle(self, max_steps: int = 100000) -> int:
        """Drive until every live replica is idle (all fleet requests
        terminal — relocation is synchronous inside `step()`, so idle
        really means done). Per-replica stall recovery belongs to each
        frontend's watchdog; `max_steps` bounds runaway loops."""
        for n in range(max_steps):
            if self.idle:
                return n
            self.step()
        if not self.idle:
            raise RuntimeError(f"fleet not idle after {max_steps} steps")
        return max_steps

    # ---- one-surface reporting ----
    def _publish_gauges(self):
        _monitor.set_gauge("fleet.replicas_total", len(self._replicas))
        _monitor.set_gauge("fleet.replicas_alive",
                           sum(r.alive for r in self._replicas))
        _monitor.set_gauge("fleet.replicas_draining",
                           sum(r.alive and r.draining
                               for r in self._replicas))

    def replica_snapshots(self) -> List[dict]:
        """Per-replica numeric snapshots in `aggregate_mesh`'s injectable
        format: `fleet.*` load/throughput plus the `mesh.step_wall_ms`
        key straggler attribution feeds on."""
        snaps = []
        _no_load = {"queue_depth": 0, "running": 0, "queued_cost": 0,
                    "kv_utilization": 0.0, "prefix_hit_rate": 0.0}
        for rep in self._replicas:
            # a dead replica's scheduler is frozen pre-crash state, not
            # load — report its historical throughput, zero its load
            ld = rep.load() if rep.alive else _no_load
            snaps.append({
                "fleet.alive": int(rep.alive),
                "fleet.tokens_generated": rep.tokens_produced,
                "fleet.steps": rep.steps,
                "fleet.queue_depth": ld["queue_depth"],
                "fleet.running": ld["running"],
                "fleet.queued_cost": ld["queued_cost"],
                "fleet.kv_utilization_pct":
                    round(ld["kv_utilization"] * 100.0, 1),
                "fleet.prefix_hit_rate_pct":
                    round(ld.get("prefix_hit_rate", 0.0) * 100.0, 1),
                "mesh.step_wall_ms": rep.last_step_wall_ms,
            })
        return snaps

    def fleet_summary(self) -> dict:
        """The fleet as ONE surface: per-replica snapshots aggregated
        through `monitor.aggregate_mesh` (summed load/throughput,
        straggler replica from per-replica step walls) plus the router's
        own `fleet.*` counters."""
        self._publish_gauges()
        snaps = self.replica_snapshots()
        mesh = _monitor.aggregate_mesh(snapshots=snaps)
        counters = _monitor.snapshot("fleet.", include_histograms=False)
        out = {
            "replicas": len(self._replicas),
            "alive": sum(r.alive for r in self._replicas),
            "draining": sum(r.alive and r.draining
                            for r in self._replicas),
            "dead": {r.replica_id: r.death_reason
                     for r in self._replicas
                     if not r.alive and r.death_reason != "drained"},
            "roles": {r.replica_id: r.role for r in self._replicas},
            "aggregate": mesh["sum"],
            "straggler_replica":
                None if mesh.get("straggler_host") is None
                else self._replicas[mesh["straggler_host"]].replica_id,
            "step_wall_spread_pct": mesh.get("step_wall_spread_pct"),
            "counters": counters,
        }
        return out

    def close(self):
        """Deregister every live replica, stop the step pool, and drop a
        router-owned temp membership store."""
        for rep in self._replicas:
            if rep.alive:
                try:
                    self.store.deregister(rep.replica_id,
                                          incarnation=rep.incarnation)
                except Exception:
                    pass
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._own_store_path:
            for p in (self._own_store_path,
                      self._own_store_path + ".lock"):
                try:
                    os.remove(p)
                except OSError:
                    pass
            self._own_store_path = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
