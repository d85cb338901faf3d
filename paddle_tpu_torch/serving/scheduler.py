"""Continuous-batching scheduler over an `EngineCore` (the port of
`paddle_tpu/serving/scheduler.py`).

Policy:
- admission: FIFO from the waiting queue into free slots. Admission
  leases the deepest radix-cached prefix of the context when the prefix
  cache is on, else only the sequence id (one block); the rest of the
  context's KV enters the cache chunk by chunk through the ragged step.
  A request is admitted only when its whole context could lease now,
  after the prefill debt of lanes still mid-chunking; pool exhaustion
  leaves it queued.
- prefix caching (optional, `prefix_cache=True`): a radix tree over the
  paged pool publishes committed KV at finish / preemption and leases the
  deepest cached prefix at admission (no prefill for the hit; chunking
  resumes from the first uncached token, and a full hit leaves one
  token). Divergent writes into shared blocks copy on write
  (`engine.copy_kv_block`); unpinned tree nodes LRU-evict under pressure.
- multi-tenant SLOs (optional, `slo=SLOConfig(...)`): per-tenant KV quotas
  and reserves gate admission without cross-tenant head blocking,
  admission order is deficit-weighted fair across tenants, and each tier
  scales the overload watermarks with its own latches.
- load shedding (optional `AdmissionConfig`): watermark latches with
  hysteresis over queue depth, queued `max_new_tokens` cost and KV
  utilization, plus deadline-aware early shedding: overload degrades to
  fast SHED responses.
- chunked prefill: every step packs the decode lanes (one token each)
  plus at most `prefill_chunk_tokens` pending-prompt tokens into ONE
  `engine.ragged_step` over a packed buffer of `max_batch_size +
  prefill_chunk_tokens` slots. The first token samples when the final
  chunk completes.
- preemption: when a running sequence cannot grow (pool exhausted), the
  most recently admitted other sequence goes back to the FRONT of the
  queue (LIFO victim, FIFO service), keeping its tokens; they are
  re-prefilled on re-admission.
- eviction: finished, cancelled and expired sequences free their blocks
  at once; the slot admits a new request on the same step.
- padding: empty lanes point their block table at a dedicated guard
  block, never at a sequence's block.
- fault isolation: every engine dispatch runs behind a typed boundary
  (`serving/fault_tolerance.py`). Faults attributable to lanes (non-finite
  logits, a typed `EngineStepError(seq_ids=...)`, cache failures, failed
  probe replays) fail ONLY those requests; survivors roll back to their
  pre-step cache lengths and replay next round with identical tokens.
  Unattributed faults (a kernel launch that raises for every lane alike)
  retry at most `step_retries` times in a row, then escalate to the
  watchdog. Nothing replaces a failing kernel with a plain version.
- watchdog (optional `WatchdogConfig` + `engine_factory`): stall
  detection (per-dispatch wall clock + zero-progress rounds) drives a
  bounded-restart supervisor: in-flight sequences re-queue with their
  tokens, the engine is rebuilt, the guard block and the prefix tree are
  rebuilt on the fresh pool. Out of budget, every non-terminal request
  fails typed (`engine_unrecoverable:*`).
- speculative decoding (optional, `spec=SpecDecodeConfig`): each round a
  proposer drafts up to K tokens per decode lane, and ONE
  `engine.verify_step` scores every lane's fixed window of K + 1 tokens
  (pending token + drafts, or the next prompt tokens of a prefilling
  lane); the longest matching draft prefix plus one bonus/correction
  token commit, and rejected speculation rolls back with
  `BlockCacheManager.trim`. A proposer out of pool or past its length
  cap drafts nothing; any other proposer error rolls the round back and
  propagates. Greedy and seeded-stochastic streams equal plain
  decoding's, token for token.

- multi-LoRA lanes (an engine with an `adapter_pool`, `serving/lora.py`):
  a request naming an adapter leases it at admission, BEFORE its KV
  lease; a resident adapter admits for free, a miss (an upload, perhaps
  an eviction) spends `adapter_miss_loads_per_step`, and a full pool
  leaves the request queued. The lease is released at every exit, and
  the lane -> slot vector is installed before every ragged / verify
  dispatch.
- KV migration (`inference/kv_migrate.py`): `import_session` admits a
  request whose context KV arrives as a payload instead of through
  prefill, `release` takes a request out without a terminal status, and
  `export_prefix` / `import_prefix` stream a radix-cached prefix between
  schedulers (a fleet router sets `prefix_stream_hook` to pull a peer's
  copy on an admission-time miss, `serving/fleet.py`).
- the serving timeline (`observability/timeline.py`, with
  `observability.enable()`): each request's lifecycle edges (queued,
  admitted, prefill, decode and verify rounds, preempted, terminal) and
  each engine dispatch land as events; a step fault, an engine restart
  and a failed request dump the flight recorder. Every site checks
  `observability.enabled()` first, so the disabled path allocates
  nothing.

Sampling is `ops/sampling.py` on the logits' device: logits stay on the
card, and only the [B] token ids and the [T] finite mask cross to the
host each step.
"""
from __future__ import annotations

import enum
import itertools
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from .. import observability as _obs
from ..framework import monitor
from ..framework.retry import Budget, retry_call
from ..inference.cache import KVCacheExhausted, SequenceTooLong
from ..inference.kv_migrate import KVMigrationError
from ..inference.prefix_cache import RadixPrefixCache
from ..observability import timeline as _timeline
from ..ops.sampling import sample_tokens
from ..resilience import faults
from .engine import EngineCore
from .fault_tolerance import (AdmissionConfig, EngineStepError,
                              OverloadController, WatchdogConfig)
from .lora import AdapterPoolExhausted
from .metrics import ServingMetrics
from .slo import DEFAULT_TENANT, SLOConfig
from .spec import SpecDecodeConfig

__all__ = ["SamplingParams", "RequestStatus", "Request", "Scheduler"]

_PAD_SEQ_ID = -1


class SamplingParams:
    """Per-request decoding knobs (greedy by default)."""

    def __init__(self, max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, eos_token_id: Optional[int] = None,
                 seed: int = 0):
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_token_id = eos_token_id
        self.seed = seed


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"     # back in queue, tokens-so-far kept
    FINISHED = "finished"
    CANCELLED = "cancelled"
    REJECTED = "rejected"
    SHED = "shed"               # overload admission control turned it away
    FAILED = "failed"           # engine fault isolated to this request
    TIMED_OUT = "timed_out"

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.FINISHED, RequestStatus.CANCELLED,
                        RequestStatus.REJECTED, RequestStatus.SHED,
                        RequestStatus.FAILED, RequestStatus.TIMED_OUT)


class Request:
    """One generation request and its lifecycle bookkeeping."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, sampling: Optional[SamplingParams] = None,
                 deadline: Optional[float] = None,
                 stream_cb: Optional[Callable[["Request", int], None]] = None,
                 tenant: str = DEFAULT_TENANT,
                 adapter: Optional[str] = None):
        self.req_id = next(Request._ids)
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.sampling = sampling or SamplingParams()
        self.deadline = deadline              # absolute, scheduler's clock
        self.stream_cb = stream_cb
        # multi-tenant SLO class (serving/slo.py): quota, lane weight and
        # watermark tier key off this; "default" = untiered
        self.tenant = tenant or DEFAULT_TENANT
        # multi-LoRA serving (serving/lora.py): the registered adapter of
        # this request's lanes; None = the base model. `_adapter_slot` is
        # not None exactly while the request holds one lease in the
        # CURRENT engine's pool (taken at admission, dropped at every exit,
        # and cleared without a release when an engine swap discards the
        # pool with the engine)
        self.adapter = adapter
        self._adapter_slot: Optional[int] = None
        self.generated: List[int] = []
        self.status = RequestStatus.QUEUED
        self.finish_reason: Optional[str] = None
        self.num_preemptions = 0
        # fleet placement (serving/fleet.py): the replica serving this
        # request now, and how often a replica death or drain moved it;
        # None / 0 under a standalone frontend
        self.replica_id: Optional[str] = None
        self.num_relocations = 0
        self.session_id: Optional[str] = None
        self.t_submit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self._last: Optional[int] = None      # sampled, KV not yet written
        self._admit_seq = -1                  # admission order (victim pick)
        # chunked-prefill cursor: context tokens whose KV is already in
        # cache; the target snapshot is taken at every (re-)admission, so
        # a re-prefill after preemption replays prompt + kept tokens. A
        # prefix-cache hit starts the cursor AT the hit length.
        self._prefill_ctx = np.zeros((0,), np.int32)
        self._prefill_pos = 0
        self._prefix_hit_tokens = 0           # cached tokens this admission
        self._chunks = 0                      # prefill chunks this admission
        self._t_admit: Optional[float] = None
        # the context KV arrived as a migrated payload (`import_session`):
        # admission skips the lease and prefill of that context; cleared
        # at admission, and a queue exit before then frees the blocks
        # (`_drop_resident_kv`)
        self._kv_resident = False

    @property
    def prefilling(self) -> bool:
        """True while context KV is still entering the cache chunk-wise."""
        return self._prefill_pos < len(self._prefill_ctx)

    @property
    def seq_id(self) -> int:
        return self.req_id

    @property
    def cost(self) -> int:
        """Admission-control weight: decode steps this request may still
        consume (`max_new_tokens` less what it already produced)."""
        return max(1, self.sampling.max_new_tokens - len(self.generated))

    def all_tokens(self) -> np.ndarray:
        """Prompt + every generated token INCLUDING the pending last one:
        the stream a speculative proposer continues from."""
        return np.concatenate([
            self.prompt, np.asarray(self.generated, np.int32)]).astype(
                np.int32)

    def context_tokens(self) -> np.ndarray:
        """Tokens whose KV must be in cache before the next decode: the
        prompt plus every generated token EXCEPT the pending last one
        (the decode step itself writes the pending token's KV)."""
        gen = self.generated[:-1] if self._last is not None else self.generated
        return np.concatenate([self.prompt,
                               np.asarray(gen, np.int32)]).astype(np.int32)

    def ttft(self) -> Optional[float]:
        if self.t_first_token is None or self.t_submit is None:
            return None
        return self.t_first_token - self.t_submit

    def tpot(self) -> Optional[float]:
        """Mean time-per-output-token after the first."""
        if (self.t_finish is None or self.t_first_token is None
                or len(self.generated) < 2):
            return None
        return (self.t_finish - self.t_first_token) / (len(self.generated) - 1)


def _all_finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x)).all())


class Scheduler:
    """Admits requests into decode slots and drives ragged steps."""

    def __init__(self, engine: EngineCore,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: int = 256, prefill_chunk_tokens: int = 32,
                 spec: Optional[SpecDecodeConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 admission: Optional[AdmissionConfig] = None,
                 watchdog: Optional[WatchdogConfig] = None,
                 engine_factory: Optional[Callable[[], EngineCore]] = None,
                 nan_checks: bool = True,
                 prefix_cache: bool = False,
                 slo: Optional[SLOConfig] = None):
        """`prefill_chunk_tokens`: per-step token budget for pending
        prompts; the packed ragged dispatch holds `max_batch_size +
        prefill_chunk_tokens` token slots. `spec`: optional
        `SpecDecodeConfig`; every round is then one `verify_step`.
        `clock`: the time source of deadlines, latency stamps and stall
        detection (tests inject a fake one).

        `admission`: optional `AdmissionConfig` (load shedding).
        `watchdog` + `engine_factory`: stall detection and bounded engine
        restarts; a factory alone opts into the default `WatchdogConfig`
        (it would otherwise never run). `nan_checks`: screen every
        step's logits for non-finite rows (on by default; an injected
        `"flag"` fault screens regardless). `prefix_cache`: the
        shared-prefix radix cache (`inference/prefix_cache.py`). `slo`:
        optional multi-tenant `SLOConfig` (serving/slo.py)."""
        if prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1, got "
                             f"{prefill_chunk_tokens}")
        self.engine = engine
        self.metrics = metrics or ServingMetrics()
        self.max_queue = max_queue
        self.spec = spec
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.ragged_tokens = engine.max_batch_size + self.prefill_chunk_tokens
        self.engine_factory = engine_factory
        self.nan_checks = nan_checks
        self._overload = OverloadController(admission) if admission else None
        if watchdog is None and engine_factory is not None:
            watchdog = WatchdogConfig()
        self._wd = watchdog
        self._restart_budget = Budget(
            watchdog.max_restarts if watchdog is not None else 0)
        self._clock = clock
        self.slots: List[Optional[Request]] = [None] * engine.max_batch_size
        self.waiting: Deque[Request] = deque()
        self._queued_cost = 0          # sum of waiting requests' .cost
        self._admit_counter = itertools.count()
        # recent decode/verify dispatch wall times; the deadline-shed
        # estimate uses the MEDIAN, which one slow outlier cannot drag
        self._tpot_samples: Deque[float] = deque(maxlen=32)
        self._zero_progress = 0        # consecutive no-progress steps
        self._finish_events = 0        # terminal transitions, monotonic
        # tokens committed to request streams over this scheduler's life
        # (decode, first tokens, speculative accepts): the per-replica
        # throughput the fleet aggregates (monitor counters are global)
        self.tokens_committed = 0
        self._chunk_progress = 0       # prefill tokens last round
        self._step_faults = 0          # consecutive unattributed faults
        self._pending_stall: Optional[str] = None
        self._broken: Optional[str] = None   # rebind failed mid-restart
        self._last_decode_dt: Optional[float] = None
        self._prefix_enabled = bool(prefix_cache)
        self._prefix_tree: Optional[RadixPrefixCache] = None
        self._slo = slo
        # per-tenant overload controllers (tier-scaled watermarks, own
        # latches) and virtual-time clocks of the deficit-weighted
        # admission order, both lazy; `_vclock` is the system virtual
        # time (the last admission's start), so a tenant returning from
        # idle competes from NOW instead of spending banked arrears
        self._overload_by_tenant = {}
        self._vtime = {}
        self._vclock = 0.0
        # multi-LoRA admission pricing: adapter-MISS admissions (an upload,
        # perhaps an eviction) one admission round may pay for; resident
        # adapters admit for free and never count against it
        self.adapter_miss_loads_per_step = 1
        self._bind_manager(engine.manager)

    def _bind_manager(self, mgr):
        """(Re)lease the guard block, derive pool geometry, build the
        prefix tree and publish the engine's quantization mode — at
        construction and again after every watchdog engine rebuild."""
        # Guard block for padded lanes: empty slots point their block
        # table at this block. Negative ids keep it out of the request id
        # space; probe downward in case another scheduler already leases
        # -1 on a shared engine.
        pad_id = _PAD_SEQ_ID
        while True:
            try:
                self._pad_block = mgr.allocate(pad_id, 1)[0]
                break
            except ValueError:
                pad_id -= 1
        self._pad_seq_id = pad_id
        # what one sequence can ever hold: pool minus the guard (and minus
        # blocks other users of a shared engine already lease)
        self._usable_blocks = min(mgr.free_blocks, mgr.max_blocks_per_seq)
        # prefix streaming between schedulers: `_mig_seq` mints transient
        # sequence ids for the export / import lease (negative, far below
        # the guard's probe range); the hook (set by a router) is asked
        # for a peer's cached copy on an admission-time radix miss
        self._mig_seq = -(1 << 30)
        self.prefix_stream_hook: Optional[Callable] = None
        # the radix tree lives on THIS manager (a fresh one after an
        # engine swap: the old tree's KV died with the old pool); the
        # engine's block copy backs copy-on-write, and the tree is the
        # pool's eviction authority
        if self._prefix_enabled:
            self._prefix_tree = RadixPrefixCache(mgr)
            mgr.set_reclaimer(self._prefix_tree)
            mgr.set_cow_hook(getattr(self.engine, "copy_kv_block", None))
        # the wbits / kv_bits / kv_bytes_per_token gauges: bind-time, not
        # per step
        info = getattr(self.engine, "quant_info", None)
        if info is not None:
            try:
                self.metrics.on_quant(info())
            except Exception:
                # bind must survive a broken hook, but not silently: the
                # unset gauges and this counter point at the cause
                monitor.inc("serving.quant_info_errors")
        # the multi-LoRA surface, re-resolved after every engine swap: the
        # adapter pool leases at admission, and the lane -> slot vector is
        # pushed before each dispatch
        self._lora = getattr(self.engine, "adapter_pool", None)
        self._set_lanes = getattr(self.engine, "set_lane_adapters", None)
        self._lora_zero = int(getattr(self.engine, "zero_slot", 0))
        # a swap killed the old pool with the old engine: a request still
        # holding an old slot re-leases from the fresh pool at admission
        for req in self.waiting:
            req._adapter_slot = None
        for req in self.slots:
            if req is not None:
                req._adapter_slot = None
        linfo = getattr(self.engine, "lora_info", None)
        if linfo is not None:
            try:
                self.metrics.on_lora(linfo())
            except Exception:
                monitor.inc("serving.lora_info_errors")

    # ---- waiting-queue bookkeeping (cost-accounted) ----
    def _queue_push(self, req: Request, front: bool = False):
        if front:
            self.waiting.appendleft(req)
        else:
            self.waiting.append(req)
        self._queued_cost += req.cost
        self.metrics.gauge_queue(len(self.waiting), self._queued_cost)

    def _queue_remove(self, req: Request):
        self.waiting.remove(req)
        self._queued_cost = max(0, self._queued_cost - req.cost)
        self.metrics.gauge_queue(len(self.waiting), self._queued_cost)

    # ---- submission / cancellation ----
    def submit(self, req: Request, now: Optional[float] = None) -> Request:
        """Admission control. Rejects or sheds (with `finish_reason`)
        instead of raising: empty and over-long prompts, a full queue and
        overload watermarks are load conditions, not bugs."""
        now = self._clock() if now is None else now
        req.t_submit = now
        self.metrics.on_submit()
        if _obs.enabled():
            self._obs_req(req, "queued", t0=now,
                          prompt_tokens=int(len(req.prompt)),
                          max_new_tokens=req.sampling.max_new_tokens)
        if self._broken is not None:
            return self._reject(req, self._broken)
        mgr = self.engine.manager
        if len(req.prompt) == 0:
            return self._reject(req, "empty_prompt")
        # +1: the sequence must be able to hold at least one generated token
        if mgr.blocks_needed(len(req.prompt) + 1) > self._usable_blocks:
            return self._reject(req, "prompt_too_long")
        if req.adapter is not None:
            # an unknown adapter can never become leasable by waiting
            if self._lora is None:
                return self._reject(req, "no_adapter_pool")
            if not self._lora.is_registered(req.adapter):
                return self._reject(req, "unknown_adapter")
        if self._overload is not None:
            ctrl = self._overload_for(req.tenant)
            tpot = (self.tpot_estimate()
                    if ctrl.cfg.deadline_aware and req.deadline is not None
                    else None)
            reason = ctrl.shed_reason(
                queue_depth=len(self.waiting),
                queued_cost=self._queued_cost,
                req_cost=req.cost,
                kv_utilization=mgr.utilization(),
                deadline=req.deadline, now=now,
                tpot_s=tpot, lanes=len(self.slots))
            if reason is not None:
                return self._shed(req, reason)
        if len(self.waiting) >= self.max_queue:
            return self._reject(req, "queue_full")
        self._queue_push(req)
        return req

    def import_session(self, req: Request, payload,
                       now: Optional[float] = None) -> Request:
        """Admit a request whose context KV arrives as a migrated
        `KVBlockPayload` (`inference/kv_migrate.py`) instead of through
        chunked prefill: a session handed over from another engine.

        Load conditions come back as terminal statuses, as in `submit`
        (broken scheduler, empty prompt, over-long context, full queue),
        all checked BEFORE the pool is touched. Migration problems raise
        typed: `KVMigrationError` (a header mismatch, a token count that
        is not the request's committed context, or an engine without the
        primitive) and the manager's `KVCacheExhausted` /
        `SequenceTooLong` from the inject's allocation. On success the
        blocks sit under `req.seq_id`, `_admit` skips the lease and the
        prefill of that context, and a pending `_last` token decodes in
        the importing scheduler's next round. Overload shedding is
        skipped: the import carries prefill work already spent."""
        now = self._clock() if now is None else now
        if req.t_submit is None:
            req.t_submit = now
        self.metrics.on_submit()
        if _obs.enabled():
            self._obs_req(req, "queued", t0=now, imported_kv=True,
                          prompt_tokens=int(len(req.prompt)),
                          max_new_tokens=req.sampling.max_new_tokens)
        if self._broken is not None:
            return self._reject(req, self._broken)
        if len(req.prompt) == 0:
            return self._reject(req, "empty_prompt")
        mgr = self.engine.manager
        if mgr.blocks_needed(int(payload.num_tokens) + 1) \
                > self._usable_blocks:
            return self._reject(req, "prompt_too_long")
        if len(self.waiting) >= self.max_queue:
            return self._reject(req, "queue_full")
        inject = getattr(self.engine, "inject_kv_blocks", None)
        if inject is None:
            raise KVMigrationError(
                f"{type(self.engine).__name__} has no inject_kv_blocks "
                "— this engine cannot accept migrated KV")
        ctx = req.context_tokens()
        if int(payload.num_tokens) != len(ctx):
            raise KVMigrationError(
                f"payload carries KV for {payload.num_tokens} tokens "
                f"but the request's committed context is {len(ctx)}")
        inject(req.seq_id, payload)     # typed errors propagate; a failed
        req._kv_resident = True         # inject leaves no blocks
        req.status = RequestStatus.QUEUED
        req.finish_reason = None
        self._queue_push(req)
        return req

    def _drop_resident_kv(self, req: Request) -> None:
        """Free KV imported by `import_session` for a request leaving the
        WAITING queue before admission claimed it (deadline, cancel,
        release, fail-all). Idempotent; never raises into a terminal
        transition."""
        if not req._kv_resident:
            return
        req._kv_resident = False
        try:
            if self.engine.manager.seq_blocks(req.seq_id) > 0:
                self.engine.manager.free(req.seq_id)
        except Exception:
            monitor.inc("serving.kv_migrate.drop_errors")

    def _overload_for(self, tenant: str) -> OverloadController:
        """The shared overload controller without an SLO config; with
        one, a per-tenant controller with tier-scaled watermarks and
        private hysteresis latches."""
        if self._slo is None:
            return self._overload
        ctrl = self._overload_by_tenant.get(tenant)
        if ctrl is None:
            c = self._slo.cls(tenant)
            cfg = (self._overload.cfg if c.admission_scale == 1.0
                   else c.scaled_admission(self._overload.cfg))
            ctrl = OverloadController(cfg)
            self._overload_by_tenant[tenant] = ctrl
        return ctrl

    def _tenant_held(self) -> dict:
        """Pool blocks held per tenant (running slots only), each request
        at its COMMITTED footprint — the larger of the blocks leased now
        and the blocks its admitted context will need — so a quota cannot
        overshoot while prefill chunks are still landing. A shared prefix
        charges each tenant holding it."""
        mgr = self.engine.manager
        held: dict = {}
        for r in self.slots:
            if r is not None:
                blocks = max(mgr.seq_blocks(r.seq_id),
                             mgr.blocks_needed(len(r._prefill_ctx) + 1))
                held[r.tenant] = held.get(r.tenant, 0) + blocks
        return held

    def prefix_stats(self) -> Optional[dict]:
        """The prefix tree's counters (None with the cache off)."""
        t = self._prefix_tree
        return None if t is None else t.stats()

    @property
    def prefix_cache(self) -> Optional[RadixPrefixCache]:
        return self._prefix_tree

    # ---- prefix streaming between schedulers ----
    def _mig_seq_id(self) -> int:
        """A fresh transient sequence id for a prefix-stream lease:
        negative and far below the guard's probe range, so it collides
        neither with request ids nor with another scheduler's guard on a
        shared engine."""
        mgr = self.engine.manager
        while True:
            self._mig_seq -= 1
            if mgr.seq_blocks(self._mig_seq) == 0:
                return self._mig_seq

    def export_prefix(self, tokens):
        """The radix-cached KV of the longest FULL-block cached prefix of
        `tokens` as a migration payload, gathered through a transient
        lease (adopt, extract, free): the tree's pins and every running
        request are untouched. None when there is nothing to ship: the
        cache off, an engine without the primitive, or a hit shorter
        than one block."""
        tree = self._prefix_tree
        extract = getattr(self.engine, "extract_kv_blocks", None)
        if tree is None or extract is None:
            return None
        blocks, hit = tree.match_export(tokens)
        if not blocks:
            return None
        mgr = self.engine.manager
        tmp = self._mig_seq_id()
        mgr.adopt(tmp, blocks, hit)
        try:
            return extract(tmp)
        finally:
            mgr.free(tmp)

    def import_prefix(self, tokens, payload) -> int:
        """Publish a streamed prefix payload (a peer's `export_prefix` of
        `tokens`) into THIS scheduler's radix tree: inject under a
        transient sequence, publish the full blocks, free the lease (the
        tree's pins keep the KV; blocks whose content the tree already
        indexes go back to the pool). Returns the cached tokens gained; 0
        when the tree already covers the payload, the pool has no room
        (a stream must not pressure a loaded pool), or the cache or the
        primitive is off. Typed migration errors propagate."""
        tree = self._prefix_tree
        inject = getattr(self.engine, "inject_kv_blocks", None)
        if tree is None or inject is None:
            return 0
        toks = np.asarray(tokens).reshape(-1).tolist()
        n = int(payload.num_tokens)
        if n < 1 or len(toks) < n:
            return 0
        _blocks, local = tree.match_export(toks)
        if local >= n:
            return 0
        mgr = self.engine.manager
        if int(payload.num_blocks) > min(mgr.free_blocks,
                                         self._usable_blocks):
            return 0
        tmp = self._mig_seq_id()
        inject(tmp, payload)
        try:
            added = tree.publish(tmp, toks[:n])
        finally:
            mgr.free(tmp)
        return n if added else 0

    def _reject(self, req: Request, reason: str) -> Request:
        req.status = RequestStatus.REJECTED
        req.finish_reason = reason
        req.t_finish = self._clock()
        self.metrics.on_reject(reason)
        if _obs.enabled():
            self._obs_req(req, "terminal:rejected", t0=req.t_finish,
                          reason=reason)
        return req

    def _shed(self, req: Request, reason: str) -> Request:
        req.status = RequestStatus.SHED
        req.finish_reason = reason
        req.t_finish = self._clock()
        self.metrics.on_shed(reason)
        if _obs.enabled():
            self._obs_req(req, "terminal:shed", t0=req.t_finish,
                          reason=reason)
        return req

    def in_flight(self) -> List[Request]:
        """Every non-terminal request this scheduler owns: the running
        slots in admission order, then the waiting queue."""
        running = sorted(((r._admit_seq, i) for i, r in
                          enumerate(self.slots) if r is not None))
        return [self.slots[i] for _, i in running] + list(self.waiting)

    def release(self, req: Request) -> bool:
        """Take a non-terminal request out of this scheduler WITHOUT a
        terminal status: its blocks are freed, its speculative state and
        adapter lease dropped, and it lands in PREEMPTED with its tokens
        so far (the preemption invariant), so a re-submission elsewhere
        replays token-deterministically. It is not re-queued here and no
        preemption is counted. False when the request is terminal or not
        owned here."""
        if req.status.terminal:
            return False
        if req in self.waiting:
            self._queue_remove(req)
            self._drop_resident_kv(req)
            self._adapter_release(req)
            req.status = RequestStatus.PREEMPTED
            return True
        for i, r in enumerate(self.slots):
            if r is req:
                self.slots[i] = None
                self._publish_prefix(req)
                self.engine.manager.free(req.seq_id)
                self._release_spec(req)
                self._adapter_release(req)
                req.status = RequestStatus.PREEMPTED
                return True
        return False

    def cancel(self, req: Request) -> bool:
        if req.status.terminal:
            return False
        if req in self.waiting:
            self._queue_remove(req)
            self._finish(req, RequestStatus.CANCELLED, "cancelled",
                         in_slot=False)
            return True
        for i, r in enumerate(self.slots):
            if r is req:
                self._finish(req, RequestStatus.CANCELLED, "cancelled",
                             slot=i)
                return True
        return False

    # ---- the step ----
    def step(self, now: Optional[float] = None) -> int:
        """One scheduling round: expire deadlines, admit into free slots,
        run one ragged step over the occupied slots. Returns the number of
        decode tokens produced."""
        now = self._clock() if now is None else now
        finish_mark = self._finish_events
        self._expire(now)
        admitted = self._admit()
        produced = self._decode()
        # progress = tokens, prefill chunks, admissions or terminal
        # transitions; a non-idle scheduler sustaining zero progress is
        # wedged (the watchdog's restart trigger)
        if produced > 0 or admitted > 0 or self._chunk_progress > 0 \
                or self._finish_events > finish_mark:
            self._zero_progress = 0
        else:
            self._zero_progress += 1
        if self._pending_stall is not None:
            reason, self._pending_stall = self._pending_stall, None
            self._stall(reason)
        elif (self._wd is not None and not self.idle
                and self._zero_progress >= self._wd.stall_steps):
            self._stall("zero_progress")
        self.metrics.on_step(
            occupancy=produced / len(self.slots),
            kv_utilization=self.engine.manager.utilization(),
            queue_depth=len(self.waiting),
            decoded=produced > 0)
        return produced

    @property
    def num_running(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def idle(self) -> bool:
        return self.num_running == 0 and not self.waiting

    @property
    def zero_progress_steps(self) -> int:
        """Consecutive steps with no token, prefill chunk, admission or
        finish — the frontend raises `EngineStalled` off this when no
        watchdog runs."""
        return self._zero_progress

    @property
    def engine_restarts_remaining(self) -> int:
        return self._restart_budget.remaining

    @property
    def watchdog_active(self) -> bool:
        """True when a watchdog owns stall recovery: the frontend's
        `stall_after` fallback stands down."""
        return self._wd is not None

    def tpot_estimate(self) -> Optional[float]:
        """Median recent decode-dispatch wall time (s), or None before
        the first timed dispatch — what deadline-aware shedding prices a
        queued token at."""
        if not self._tpot_samples:
            return None
        return float(np.median(np.asarray(self._tpot_samples)))

    def kv_leaked_blocks(self) -> int:
        """Blocks leased in the manager that belong to neither the guard,
        a running sequence, nor the prefix tree; 0 for a sole-tenant
        scheduler. Counted over UNIQUE physical blocks."""
        mgr = self.engine.manager
        held = mgr.num_blocks - mgr.free_blocks
        legit = set(mgr.blocks_of(self._pad_seq_id))
        for r in self.slots:
            if r is not None:
                legit.update(mgr.blocks_of(r.seq_id))
        if self._prefix_tree is not None:
            legit.update(self._prefix_tree.blocks())
        return held - len(legit)

    def _publish_prefix(self, req: Request) -> None:
        """Publish a departing request's committed context KV into the
        radix tree (full blocks only) BEFORE the manager frees its
        lease. A prefilling lane publishes only the chunks already
        committed; publication never breaks the terminal-status path (a
        failure is counted)."""
        tree = self._prefix_tree
        if tree is None:
            return
        mgr = self.engine.manager
        if not mgr.seq_blocks(req.seq_id):
            return
        try:
            if req.prefilling:
                toks = req._prefill_ctx[
                    :min(req._prefill_pos, mgr.seq_len(req.seq_id))]
            else:
                toks = req.context_tokens()
                toks = toks[:min(len(toks), mgr.seq_len(req.seq_id))]
            if len(toks) >= mgr.block_size:
                tree.publish(req.seq_id, toks)
        except Exception:
            monitor.inc("serving.prefix_cache.publish_errors")

    # ---- fault boundary ----
    def _dispatch(self, phase: str, fn, *args):
        """One engine dispatch behind the typed fault boundary: the
        `serve.<phase>` injection site fires here, the wall clock feeds
        the TPOT estimate and the watchdog's stall detection, and a
        `"flag"` injection asks the caller to poison one lane (the NaN
        path). Returns (result, flagged)."""
        flagged = faults.check_flag(f"serve.{phase}")
        t0 = self._clock()
        try:
            out = fn(*args)
        finally:
            dt = self._clock() - t0
            if self._wd is not None and dt > self._wd.stall_timeout_s:
                self.metrics.on_stall()
                self._pending_stall = f"step_timeout:{phase}"
        if phase in ("decode", "verify"):
            # successful dispatches only: fast failures must not drag the
            # median toward zero while the engine is unhealthy
            self._last_decode_dt = dt
        if _obs.enabled():
            _timeline.dispatch_span(phase, t0, t0 + dt)
        return out, flagged

    def _obs_req(self, req: Request, name: str, t0: Optional[float] = None,
                 t1: Optional[float] = None, **meta):
        """A request-track timeline event; call sites check
        `_obs.enabled()` first, so the disabled path allocates nothing. A
        LoRA request's adapter rides every event (whose TTFT paid an
        adapter load, without a metrics join)."""
        if req.adapter is not None and "adapter" not in meta:
            meta["adapter"] = req.adapter
        _timeline.request_event(
            req.req_id, name, self._clock() if t0 is None else t0, t1,
            **meta)

    def _record_tpot(self, n_lanes: int, produced: int):
        """Price the last decode/verify dispatch per lane-token: `dt /
        (produced / n_lanes)` (a verify commits up to K + 1 per lane)."""
        if produced > 0 and self._last_decode_dt is not None:
            self._tpot_samples.append(
                self._last_decode_dt * n_lanes / produced)

    def _finite_rows(self, logits) -> np.ndarray:
        """Row-finiteness mask reduced on the logits' device: only [T]
        bools cross to the host, never the [T, V] logits."""
        return torch.isfinite(torch.as_tensor(logits)).all(dim=-1) \
            .cpu().numpy()

    def _isolated(self, req: Request, reason: str, phase: str,
                  slot: Optional[int] = None, in_slot: bool = True):
        """Fail ONE request at the fault boundary; everyone else keeps
        serving."""
        self.metrics.on_isolated_fault(phase)
        self._finish(req, RequestStatus.FAILED, reason, slot=slot,
                     in_slot=in_slot)

    def _step_fault(self, phase: str, exc: BaseException, lanes,
                    probe=None, rollback=None):
        """A whole-batch dispatch raised. Attribute it: a typed
        `EngineStepError`'s `seq_ids` are trusted; otherwise each lane is
        replayed alone (`probe`) and lanes that raise or return
        non-finite rows are culpable. Culpable requests fail; survivors
        roll back their cache bookkeeping (`rollback`) and replay next
        round. No culprit = transient: retried under `step_retries`, then
        escalated to the watchdog."""
        lanes = [(i, r) for i, r in lanes if self.slots[i] is r]
        culpable = []
        if isinstance(exc, EngineStepError) and exc.seq_ids:
            ids = set(exc.seq_ids)
            culpable = [(i, r) for i, r in lanes if r.seq_id in ids]
        elif probe is not None and not isinstance(exc, faults.InjectedFault):
            # an untargeted injected fault models a transient dispatch
            # failure: probing would find nothing
            for i, r in lanes:
                try:
                    bad = not _all_finite(probe(i, r))
                except Exception:
                    bad = True
                if bad:
                    culpable.append((i, r))
        culp_ids = {r.seq_id for _, r in culpable}
        if rollback is not None:
            rollback([(i, r) for i, r in lanes if r.seq_id not in culp_ids])
        for i, r in culpable:
            self._isolated(r, f"engine_fault:{phase}", phase, slot=i)
        if culpable:
            self._step_faults = 0
            return
        self._step_faults += 1
        self.metrics.on_step_fault(phase)
        if _obs.enabled():
            _timeline.dispatch_span(f"step_fault:{phase}", self._clock(),
                                    None, error=type(exc).__name__)
            _timeline.dump_flight(f"step_fault_{phase}")
        limit = self._wd.step_retries if self._wd is not None else 3
        if self._step_faults > limit:
            self._step_faults = 0
            self._restart_engine(f"step_faults:{phase}")

    def _stall(self, reason: str):
        if reason == "zero_progress":
            self.metrics.on_stall()
        self._zero_progress = 0
        self._restart_engine(reason)

    def _restart_engine(self, reason: str) -> bool:
        """Bounded-restart supervisor: re-queue every in-flight sequence
        with its tokens (preemption semantics), rebuild the engine
        through the factory, re-lease the guard block and rebuild the
        prefix tree on the fresh pool. Out of budget (or no factory):
        fail every non-terminal request typed."""
        # a restart resolves any stall recorded for the dispatch that
        # triggered it (else one slow, raising dispatch spends two units)
        self._pending_stall = None
        if _obs.enabled():
            # the evidence first: the ring holds the rounds that led here,
            # and the rebuild below may fail everything
            _timeline.dump_flight(f"engine_restart_{reason}")
            _timeline.dispatch_span(f"engine_restart:{reason}",
                                    self._clock(), None)
        if self.engine_factory is None or not self._restart_budget.spend():
            self._fail_all(f"engine_unrecoverable:{reason}")
            return False
        mgr = self.engine.manager
        running = sorted(((r._admit_seq, i, r)
                          for i, r in enumerate(self.slots) if r is not None),
                         reverse=True)
        for _, i, req in running:   # newest first -> oldest ends at front
            self.slots[i] = None
            try:
                mgr.free(req.seq_id)
            except KeyError:
                pass
            self._release_spec(req)
            # NOT _adapter_release: the old pool (and its lease books)
            # dies with the old engine; releasing a stale slot into the
            # FRESH pool would corrupt its refcounts
            req._adapter_slot = None
            req.status = RequestStatus.PREEMPTED
            req.num_preemptions += 1
            self._queue_push(req, front=True)
            self.metrics.on_preempt()
            if _obs.enabled():
                self._obs_req(req, "preempted", reason=f"restart:{reason}",
                              tokens_kept=len(req.generated))
        try:
            engine = retry_call(
                self.engine_factory,
                retries=self._wd.rebuild_retries if self._wd else 1,
                retry_on=(Exception,), base_delay=0.0, jitter=0.0,
                sleep=lambda _s: None,
                monitor_name="serving.engine_rebuild_retries")
            self.engine = engine
            # the rebind runs the serve.cache site (guard-block allocate):
            # it must stay inside this boundary, or a cache fault here
            # escapes step() and strands the re-queued requests
            self._bind_manager(engine.manager)
        except Exception:
            # a failed rebind can leave a stale guard-block id over the
            # fresh pool: this scheduler must not serve again
            self._broken = f"engine_rebuild_failed:{reason}"
            self._fail_all(self._broken)
            return False
        self._step_faults = 0
        self._zero_progress = 0
        # the old window priced tokens at the DEAD engine's dispatch times
        self._tpot_samples.clear()
        self._last_decode_dt = None
        self.metrics.on_engine_restart(reason)
        return True

    def _fail_all(self, reason: str):
        for i, req in enumerate(self.slots):
            if req is not None:
                self._finish(req, RequestStatus.FAILED, reason, slot=i)
        while self.waiting:
            req = self.waiting[0]
            self._queue_remove(req)
            self._finish(req, RequestStatus.FAILED, reason, in_slot=False)

    # ---- phases ----
    def _expire(self, now: float):
        for req in [r for r in self.waiting
                    if r.deadline is not None and now > r.deadline]:
            self._queue_remove(req)
            self._finish(req, RequestStatus.TIMED_OUT, "deadline_in_queue",
                         in_slot=False)
        for i, req in enumerate(self.slots):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._finish(req, RequestStatus.TIMED_OUT,
                             "deadline_while_running", slot=i)

    def _next_admit(self, mgr, skip: set) -> Optional[Request]:
        """The next request to TRY admitting. Without an SLO config:
        strict FIFO (the head). With one: deficit-weighted fair queuing
        across tenants — each tenant's head request competes, the
        eligible tenant with the lowest virtual time wins, quota-capped
        tenants are skipped WITHOUT blocking the others. None when
        nothing is eligible."""
        if self._slo is None:
            return self.waiting[0]
        heads = {}
        for r in self.waiting:          # queue order -> FIFO tie-break
            if r.tenant not in heads:
                heads[r.tenant] = r
        held = None
        eligible = []
        for t, r in heads.items():
            if t in skip:
                continue
            c = self._slo.cls(t)
            if c.kv_quota_blocks is not None:
                if held is None:
                    held = self._tenant_held()
                need_all = mgr.blocks_needed(len(r.context_tokens()) + 1)
                if held.get(t, 0) + need_all > c.kv_quota_blocks:
                    skip.add(t)         # its own finishes free quota
                    self.metrics.on_tenant_deferred(t, "kv_quota")
                    continue
            eligible.append((t, r))
        if not eligible:
            return None
        # effective time = max(own clock, system clock): an idle tenant's
        # stale low clock fast-forwards to NOW
        _best_t, best_r = min(
            eligible,
            key=lambda tr: max(self._vtime.get(tr[0], 0.0), self._vclock))
        return best_r

    def _charge_admission(self, tenant: str) -> None:
        if self._slo is not None:
            start = max(self._vtime.get(tenant, 0.0), self._vclock)
            self._vclock = start
            self._vtime[tenant] = start \
                + 1.0 / self._slo.cls(tenant).weight
            self.metrics.on_tenant_admit(tenant)

    def _admit(self) -> int:
        """Place queued requests into free slots. Admission leases the
        deepest radix-cached prefix of the context when the prefix cache
        is on (those tokens never prefill; chunking resumes from the
        first uncached token) and otherwise only the sequence id (a
        zero-token allocation = one block); the rest of the context's KV
        enters the cache chunk by chunk through the ragged step. Under an
        SLO config the order is tenant-fair (`_next_admit`) and gated by
        per-tenant quotas and reserves."""
        mgr = self.engine.manager
        admitted = 0
        skip: set = set()               # tenants deferred this round
        # adapter-miss admissions are PRICED: each pays an upload (perhaps
        # an eviction first), so only this many enter a round; resident
        # adapters admit for free
        miss_budget = self.adapter_miss_loads_per_step
        while self.waiting and None in self.slots:
            req = self._next_admit(mgr, skip)
            if req is None:
                break                  # every queued tenant deferred
            ctx = req.context_tokens()
            # admit only when the WHOLE context could lease right now,
            # after the prefill DEBT of admitted lanes still mid-chunking
            # (else two large prompts admit against the same free count
            # and preempt-churn mid-prefill). Radix-cached and
            # tree-reclaimable blocks both count as capacity.
            debt = sum(
                max(0, mgr.blocks_needed(len(r._prefill_ctx))
                    - mgr.seq_blocks(r.seq_id))
                for r in self.slots if r is not None and r.prefilling)
            tree = self._prefix_tree
            # imported KV (`import_session`): the context blocks are
            # already leased under seq_id, so the request needs no new
            # capacity and no radix lease
            resident = req._kv_resident and mgr.seq_blocks(req.seq_id) > 0
            hit_blocks = tree.match_blocks(ctx) \
                if tree is not None and not resident else 0
            need = 0 if resident \
                else mgr.blocks_needed(len(ctx)) - hit_blocks
            headroom = mgr.free_blocks + mgr.reclaimable_blocks() - debt
            if need > headroom:
                break                  # blocks return as runners finish
            if self._slo is not None:
                reserve = self._slo.total_reserve_excluding(
                    req.tenant, self._tenant_held())
                if need > headroom - reserve:
                    # honoring OTHER tenants' unused reserves: this
                    # tenant waits, the others may still admit
                    skip.add(req.tenant)
                    self.metrics.on_tenant_deferred(req.tenant,
                                                    "kv_reserve")
                    continue
            if req.adapter is not None and self._lora is not None:
                # the adapter lease precedes the KV lease: residency is a
                # refcount bump, a miss spends the round's load budget,
                # and a full pool defers (without an SLO config the queue
                # is strict FIFO, so a deferral ends the round)
                resident_ad = self._lora.is_resident(req.adapter)
                if not resident_ad and miss_budget <= 0:
                    if self._slo is None:
                        break
                    skip.add(req.tenant)
                    self.metrics.on_tenant_deferred(req.tenant,
                                                    "adapter_miss")
                    continue
                try:
                    req._adapter_slot = self._lora.lease(req.adapter)
                except AdapterPoolExhausted:
                    if self._slo is None:
                        break          # leases return as runners finish
                    skip.add(req.tenant)
                    self.metrics.on_tenant_deferred(req.tenant,
                                                    "adapter_pool")
                    continue
                except Exception:      # injected / failed adapter load
                    self._queue_remove(req)
                    self._isolated(req, "engine_fault:adapter", "adapter",
                                   in_slot=False)
                    continue
                if not resident_ad:
                    miss_budget -= 1
            hit = 0
            if resident:
                # the migrated KV covers the committed context and the
                # chunk cursor starts past it. Without a pending `_last`
                # token the FINAL context token re-enters as a one-token
                # chunk, so the first sample happens here (trim keeps the
                # manager's length == the attended KV; the rewrite is the
                # same content at the same slot). With `_last` pending the
                # cursor covers the whole context and the token decodes
                # next round.
                req._kv_resident = False
                target = len(ctx) if req._last is not None \
                    else max(len(ctx) - 1, 0)
                if mgr.seq_len(req.seq_id) > target:
                    mgr.trim(req.seq_id, target)
                hit = mgr.seq_len(req.seq_id)
            else:
                try:
                    if tree is not None:
                        if self.prefix_stream_hook is not None \
                                and tree.match_tokens(ctx) == 0:
                            # first miss: ask the router for a peer's
                            # cached copy before a cold prefill; the hook
                            # never raises into admission
                            try:
                                self.prefix_stream_hook(ctx)
                            except Exception:
                                monitor.inc(
                                    "serving.prefix_stream_hook_errors")
                        hit = tree.lease(req.seq_id, ctx)
                    if hit == 0:
                        mgr.allocate(req.seq_id, 0)
                except (KVCacheExhausted, SequenceTooLong):
                    # the adapter lease taken above must not outlive this
                    # failed admission attempt
                    self._adapter_release(req)
                    break
                except Exception:      # injected/corrupt cache state
                    self._queue_remove(req)
                    self._isolated(req, "engine_fault:cache", "cache",
                                   in_slot=False)
                    continue
            self._queue_remove(req)
            slot = self.slots.index(None)
            # snapshot the prefill target HERE: for a preempted
            # re-admission it includes the kept tokens, so the replay is
            # token-deterministic; the pending `_last` (when present)
            # decodes after the chunks complete. A prefix hit starts the
            # cursor AT the hit (a full hit leaves exactly one token).
            req._prefill_ctx = ctx
            req._prefill_pos = hit
            req._prefix_hit_tokens = 0 if resident else hit
            req._chunks = 0
            req._t_admit = self._clock()
            req.status = RequestStatus.RUNNING
            req._admit_seq = next(self._admit_counter)
            self.slots[slot] = req
            admitted += 1
            self._charge_admission(req.tenant)
            if tree is not None and not resident:
                # a resident cursor is migrated KV, not a radix hit
                self.metrics.on_prefix_lease(hit)
            if _obs.enabled():
                self._obs_req(req, "admitted", t0=req._t_admit, slot=slot,
                              prefix_hit_tokens=hit or None,
                              queue_wait_ms=round(
                                  (req._t_admit - req.t_submit) * 1e3, 3)
                              if req.t_submit is not None else None)
        return admitted

    def _grow_chunk(self, req: Request, slot: int, want: int) -> int:
        """Reserve cache slots for the next `want` prefill-chunk tokens.
        Under pool pressure the chunk shrinks to what the free pool (plus
        the last leased block's slack) holds before anyone is preempted.
        Returns tokens reserved (0 = nothing this round, or the request
        left the batch)."""
        mgr = self.engine.manager
        while True:
            try:
                mgr.append_tokens(req.seq_id, want)
                return want
            except SequenceTooLong:
                cap = mgr.max_blocks_per_seq * mgr.block_size \
                    - mgr.seq_len(req.seq_id)
                if cap >= 1:
                    want = min(want, cap)
                    continue
                self._finish(req, RequestStatus.FINISHED, "length_cap",
                             slot=slot)
                return 0
            except KVCacheExhausted:
                # capacity already in hand: the leased blocks' unused
                # tail, plus whatever the free pool still has
                slack = mgr.seq_blocks(req.seq_id) * mgr.block_size \
                    - mgr.seq_len(req.seq_id)
                fit = mgr.free_blocks * mgr.block_size + slack
                if 1 <= fit < want:
                    want = fit
                    continue
                if not self._preempt_one(exclude=req):
                    return 0           # sole lane over a held pool: wait

    def _grow(self, req: Request, slot: int) -> bool:
        """Account the pending token's cache slot; preempt on exhaustion.
        Returns False if the request left the batch instead. `_grow_n`
        with one token, so the plain and speculative paths share one
        length_cap / kv_capacity / preemption policy."""
        return self._grow_n(req, slot, 1) == 1

    def _grow_n(self, req: Request, slot: int, want: int) -> int:
        """Reserve cache slots for the pending token plus `want - 1` draft
        tokens. Degrades before it preempts: under pool pressure the
        drafts go first (want -> 1), THEN the preempt / finish policy
        applies. Returns the slots reserved (0 if the request left the
        batch)."""
        mgr = self.engine.manager
        while True:
            try:
                mgr.append_tokens(req.seq_id, want)
                return want
            except SequenceTooLong:
                cap = mgr.max_blocks_per_seq * mgr.block_size \
                    - mgr.seq_len(req.seq_id)
                if cap >= 1:
                    want = min(want, cap)
                    continue
                self._finish(req, RequestStatus.FINISHED, "length_cap",
                             slot=slot)
                return 0
            except KVCacheExhausted:
                if want > 1:
                    want = 1
                    continue
                if not self._preempt_one(exclude=req):
                    self._finish(req, RequestStatus.FINISHED, "kv_capacity",
                                 slot=slot)
                    return 0

    @staticmethod
    def _sampling_arrays(reqs):
        """Per-lane (temperature, top_k, seed, draw_idx) vectors for the
        sampler; `None` entries (padded lanes) sample greedy. `draw_idx`
        is tokens drawn so far, so draws are reproducible across
        preemption and slot churn. User ints are masked to 31 bits."""
        temps = np.asarray([0.0 if r is None else r.sampling.temperature
                            for r in reqs], np.float32)
        topks = np.asarray([0 if r is None else
                            int(r.sampling.top_k) & 0x7FFFFFFF
                            for r in reqs], np.int32)
        seeds = np.asarray([0 if r is None else
                            int(r.sampling.seed) & 0x7FFFFFFF
                            for r in reqs], np.int32)
        draws = np.asarray([0 if r is None else len(r.generated)
                            for r in reqs], np.int32)
        return temps, topks, seeds, draws

    def _preempt_one(self, exclude: Request) -> bool:
        """Evict the most-recently-admitted running request (≠ exclude)
        back to the FRONT of the queue, keeping its tokens so far (its
        committed KV is published into the prefix tree first)."""
        victims = [(r._admit_seq, i) for i, r in enumerate(self.slots)
                   if r is not None and r is not exclude]
        if not victims:
            return False
        _, slot = max(victims)
        req = self.slots[slot]
        self._publish_prefix(req)
        self.engine.manager.free(req.seq_id)
        self._release_spec(req)
        self._adapter_release(req)
        self.slots[slot] = None
        req.status = RequestStatus.PREEMPTED
        req.num_preemptions += 1
        self._queue_push(req, front=True)
        self.metrics.on_preempt()
        if _obs.enabled():
            self._obs_req(req, "preempted", reason="kv_pressure",
                          tokens_kept=len(req.generated))
        return True

    @staticmethod
    def _gather_rows(logits, rows: np.ndarray):
        """Each lane's last packed row, gathered on the logits' device:
        [T, V] -> [B, V]."""
        return logits[torch.as_tensor(rows, dtype=torch.long,
                                      device=logits.device)]

    def _decode(self) -> int:
        """One ragged round: decode lanes (one token each) plus up to
        `prefill_chunk_tokens` pending-prompt tokens, packed into ONE
        `engine.ragged_step` (fault site `serve.decode`). Returns decode
        tokens committed (prefill progress is tracked separately)."""
        self._chunk_progress = 0
        if self.spec is not None:
            return self._decode_spec()
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        mgr = self.engine.manager
        # grow (and possibly preempt) before building the batch arrays
        decode_lanes = []              # (slot, req)
        chunks = []                    # (slot, req, n_tokens, pre_len)
        budget = self.prefill_chunk_tokens
        for i, req in active:
            if self.slots[i] is not req:
                continue
            if req.prefilling:
                if budget <= 0:
                    continue           # next step's budget serves it
                rem = len(req._prefill_ctx) - req._prefill_pos
                pre_len = mgr.seq_len(req.seq_id)
                try:
                    got = self._grow_chunk(req, i, min(rem, budget))
                except Exception:      # injected/corrupt cache state
                    self._isolated(req, "engine_fault:cache", "cache",
                                   slot=i)
                    continue
                if got:
                    budget -= got
                    chunks.append((i, req, got, pre_len))
            else:
                try:
                    ok = self._grow(req, i)
                except Exception:      # injected/corrupt cache state
                    self._isolated(req, "engine_fault:cache", "cache",
                                   slot=i)
                    continue
                if ok:
                    decode_lanes.append((i, req))
        # growth-path preemptions may have evicted earlier entries
        decode_lanes = [(i, r) for i, r in decode_lanes
                        if self.slots[i] is r]
        chunks = [(i, r, n, p) for i, r, n, p in chunks
                  if self.slots[i] is r]
        if not decode_lanes and not chunks:
            return 0
        B = len(self.slots)
        T = self.ragged_tokens
        tokens = np.zeros((T,), np.int32)
        q_lens = np.zeros((B,), np.int32)
        kv_lens = np.zeros((B,), np.int32)
        tables = np.full((B, mgr.max_blocks_per_seq), self._pad_block,
                         np.int32)
        rows = np.zeros((B,), np.int32)   # last packed row per lane
        decode_set = {i for i, _r in decode_lanes}
        chunk_of = {i: (n, p) for i, _r, n, p in chunks}
        pre_lens = {}                     # seq_id -> pre-round cache len
        cursor = 0
        for i in range(B):                # slot order = packing order
            req = self.slots[i]
            if req is None:
                continue
            if i in decode_set:
                tokens[cursor] = req._last
                q_lens[i] = 1
                kv_lens[i] = mgr.seq_len(req.seq_id)
                pre_lens[req.seq_id] = int(kv_lens[i]) - 1
                rows[i] = cursor
                cursor += 1
            elif i in chunk_of:
                n, p = chunk_of[i]
                tokens[cursor:cursor + n] = req._prefill_ctx[
                    req._prefill_pos:req._prefill_pos + n]
                q_lens[i] = n
                kv_lens[i] = mgr.seq_len(req.seq_id)   # == p + n
                pre_lens[req.seq_id] = p
                rows[i] = cursor + n - 1
                cursor += n
            else:
                continue
            tables[i] = mgr.block_table_array([req.seq_id])[0]
        all_lanes = decode_lanes + [(i, r) for i, r, _n, _p in chunks]

        def probe(i, req):
            """Replay ONE lane of the failed step (same shapes; KV writes
            are position-indexed and idempotent with the retry). The
            lane's WHOLE packed band comes back, so a non-finite row in
            an earlier chunk row convicts it too."""
            n = int(q_lens[i])
            start = int(rows[i]) - n + 1
            t = np.zeros((T,), np.int32)
            t[:n] = tokens[start:start + n]
            q = np.zeros((B,), np.int32)
            q[i] = n
            kv = np.zeros((B,), np.int32)
            kv[i] = kv_lens[i]
            tb = np.full((B, mgr.max_blocks_per_seq), self._pad_block,
                         np.int32)
            tb[i] = tables[i]
            return self.engine.ragged_step(t, q, kv, tb)[:n]

        def rollback(survivors):
            self._rollback(survivors, pre_lens)

        self._install_lane_adapters()
        try:
            logits, flagged = self._dispatch(
                "decode", self.engine.ragged_step, tokens, q_lens, kv_lens,
                tables)
        except Exception as e:
            self._step_fault("decode", e, all_lanes, probe=probe,
                             rollback=rollback)
            return 0
        if flagged or self.nan_checks:
            if flagged:              # injection path: poison one lane
                logits = torch.as_tensor(logits).clone()
                logits[int(rows[all_lanes[0][0]])] = float("nan")
            finite = self._finite_rows(logits)      # [T] bools to host
            for i, req in all_lanes:
                n = int(q_lens[i])
                start = int(rows[i]) - n + 1
                if not bool(finite[start:start + n].all()):
                    # the garbage KV went into this lane's own blocks;
                    # freeing the sequence discards it
                    self._isolated(req, "nan_logits", "decode", slot=i)
            all_lanes = [(i, r) for i, r in all_lanes
                         if self.slots[i] is r]
            if not all_lanes:
                return 0
            decode_lanes = [(i, r) for i, r in decode_lanes
                            if self.slots[i] is r]
            chunks = [(i, r, n, p) for i, r, n, p in chunks
                      if self.slots[i] is r]
        t_tok = self._clock()
        # sampling over every lane's LAST packed row: decode lanes commit
        # their token; a prefill lane samples only on the round its final
        # chunk completes (draw_idx 0 — exactly sequential decode's draw)
        lane_sample: List[Optional[Request]] = [None] * B
        for i, req in decode_lanes:
            lane_sample[i] = req
        for i, req, n, _p in chunks:
            if req._prefill_pos + n >= len(req._prefill_ctx) \
                    and req._last is None:
                lane_sample[i] = req
        try:
            faults.check("serve.sample")
            picked = sample_tokens(
                self._gather_rows(torch.as_tensor(logits), rows),
                *self._sampling_arrays(lane_sample))
        except Exception as e:
            self._step_fault("sample", e, all_lanes, rollback=rollback)
            return 0
        self._step_faults = 0   # a full dispatch + sample round succeeded
        produced = 0
        for i, req in decode_lanes:
            if self.slots[i] is not req:   # cancelled by a stream_cb
                continue                   # earlier in this very loop
            produced += 1
            self._commit_token(req, int(picked[i]), i, t_tok,
                               obs_decode=True)
        chunk_tokens = 0
        for i, req, n, _p in chunks:
            if self.slots[i] is not req:   # cancelled mid-commit
                continue
            chunk_tokens += n
            self._commit_chunk(req, n, i, t_tok, picked[i])
        self._chunk_progress = chunk_tokens
        self.metrics.on_ragged_step(chunk_tokens, len(decode_lanes))
        if decode_lanes:
            self._record_tpot(len(decode_lanes), produced)
            self.metrics.on_decode(produced)
        return produced

    def _decode_spec(self) -> int:
        """One speculative round: propose -> ONE fixed-shape verify over
        all lanes (fault site `serve.verify`) -> sampling -> accept the
        longest matching draft prefix plus the bonus token -> `trim`
        rollback of rejected slots.

        The verify batch is always [B, K + 1] tokens. A lane with fewer
        than K drafts reserves only what it holds; the window's surplus
        KV writes land in guard-padded table entries, never in live
        blocks. Chunked prefill rides the same dispatch: a prefilling
        lane's window carries its next (up to K + 1) prompt tokens. A
        prompt never completes mid-window: the final chunk is held to
        one token, so the first token samples at window slot 0, whose
        draw counter (0) is the one plain decoding uses. Returns decode
        tokens committed."""
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        mgr = self.engine.manager
        K = self.spec.num_draft_tokens
        S = K + 1
        proposer = self.spec.proposer
        lanes = []             # (slot, req, toks, pre_len, prefilling)
        for i, req in active:
            if self.slots[i] is not req:
                continue
            pre_len = mgr.seq_len(req.seq_id)
            if req.prefilling:
                rem = len(req._prefill_ctx) - req._prefill_pos
                want = min(S, rem)
                if want == rem and rem > 1:
                    want = rem - 1      # complete next round, at slot 0
                try:
                    got = self._grow_chunk(req, i, want)
                except Exception:       # injected/corrupt cache state
                    self._isolated(req, "engine_fault:cache", "cache",
                                   slot=i)
                    continue
                if got == 0:
                    continue
                toks = list(req._prefill_ctx[
                    req._prefill_pos:req._prefill_pos + got])
                lanes.append((i, req, toks, pre_len, True))
                continue
            try:
                drafts = list(proposer.propose(
                    req.seq_id, req.all_tokens(), K))[:K]
            except (KVCacheExhausted, SequenceTooLong):
                drafts = []          # proposer pool or length pressure
            except Exception:
                # any other proposer error (a draft kernel that fails to
                # build or launch) leaves the round: the lanes grown so
                # far roll back and replay it
                self._rollback(lanes, {r.seq_id: p
                                       for _i, r, _t, p, _f in lanes})
                raise
            try:
                got = self._grow_n(req, i, 1 + len(drafts))
            except Exception:        # injected/corrupt cache state
                self._isolated(req, "engine_fault:cache", "cache", slot=i)
                continue
            if got == 0:
                continue
            lanes.append((i, req, [req._last] + drafts[:got - 1], pre_len,
                          False))
        # growth-path preemptions may have evicted earlier lanes
        lanes = [ln for ln in lanes if self.slots[ln[0]] is ln[1]]
        if not lanes:
            return 0
        B = len(self.slots)
        tokens = np.zeros((B, S), np.int32)
        ctx = np.full((B,), S, np.int32)      # pad lanes write the guard
        # a lane within S tokens of its length cap has a table full of
        # real blocks while ctx counts the whole window: trailing guard
        # columns take the window's positions past the cap
        width = mgr.max_blocks_per_seq + (S + mgr.block_size - 2) \
            // mgr.block_size
        tables = np.full((B, width), self._pad_block, np.int32)
        lane_reqs: List[Optional[Request]] = [None] * B
        pre_lens = {}
        for i, req, toks, pre_len, prefilling in lanes:
            tokens[i, :len(toks)] = toks
            # token j sits at position pre_len + j: ctx counts the whole
            # window even when the lane holds fewer than S real tokens
            ctx[i] = pre_len + S
            tables[i, :mgr.max_blocks_per_seq] = mgr.block_table_array(
                [req.seq_id], pad=self._pad_block)[0]
            # sampled rows: a decode lane's always, a prefill lane's only
            # on its completing (one-token) chunk
            if not prefilling:
                lane_reqs[i] = req
            elif req._prefill_pos + len(toks) >= len(req._prefill_ctx) \
                    and req._last is None:
                lane_reqs[i] = req
            pre_lens[req.seq_id] = pre_len

        def probe(i, req):
            t = np.zeros((B, S), np.int32)
            t[i] = tokens[i]
            c = np.full((B,), S, np.int32)
            c[i] = ctx[i]
            tb = np.full((B, width), self._pad_block, np.int32)
            tb[i] = tables[i]
            return self.engine.verify_step(t, c, tb)[i]

        def rollback(survivors):
            self._rollback(survivors, pre_lens)

        lane_pairs = [(i, r) for i, r, _t, _p, _f in lanes]
        self._install_lane_adapters()
        try:
            logits, flagged = self._dispatch(
                "verify", self.engine.verify_step, tokens, ctx, tables)
        except Exception as e:
            self._step_fault("verify", e, lane_pairs, probe=probe,
                             rollback=rollback)
            return 0
        if flagged or self.nan_checks:
            if flagged:              # injection path: poison one lane
                logits = torch.as_tensor(logits).clone()
                logits[lanes[0][0]] = float("nan")
            finite = self._finite_rows(logits).all(axis=-1)  # [B] to host
            for i, req in lane_pairs:
                if not finite[i]:
                    # the garbage KV went into this lane's own blocks (and
                    # the guard); freeing the sequence discards it
                    self._isolated(req, "nan_logits", "verify", slot=i)
                    lane_reqs[i] = None
            lanes = [ln for ln in lanes if self.slots[ln[0]] is ln[1]]
            if not lanes:
                return 0
        t_tok = self._clock()
        try:
            faults.check("serve.sample")
            picked = sample_tokens(logits, *self._sampling_arrays(lane_reqs))
        except Exception as e:
            self._step_fault("sample", e,
                             [(i, r) for i, r, _t, _p, _f in lanes],
                             rollback=rollback)
            return 0
        self._step_faults = 0   # a full verify + sample round succeeded
        produced = proposed = accepted = 0
        chunk_tokens = decode_lanes = 0
        obs_on = _obs.enabled()
        for i, req, toks, pre_len, prefilling in lanes:
            if self.slots[i] is not req:   # cancelled by a stream_cb
                continue                   # earlier in this very loop
            if prefilling:
                got = len(toks)
                chunk_tokens += got
                # a completing chunk has got == 1: window slot 0, the
                # draw counter plain decoding would use
                self._commit_chunk(req, got, i, t_tok, picked[i, got - 1])
                continue
            decode_lanes += 1
            drafts = toks[1:]
            a = 0
            while a < len(drafts) and drafts[a] == int(picked[i, a]):
                a += 1
            proposed += len(drafts)
            accepted += a
            # the accepted drafts (== the sampled tokens) plus the bonus /
            # correction token from the first unmatched position
            committed = 0
            for j in range(a + 1):
                produced += 1
                committed += 1
                self._commit_token(req, int(picked[i, j]), i, t_tok)
                if req.status.terminal:
                    break
            if obs_on:
                self._obs_req(req, "verify_round", t0=t_tok,
                              tokens=committed, drafts=len(drafts),
                              accepted=a)
            if not req.status.terminal:
                # roll back rejected speculation: keep pending + accepted
                mgr.trim(req.seq_id, pre_len + 1 + a)
        self._chunk_progress = chunk_tokens
        self.metrics.on_ragged_step(chunk_tokens, decode_lanes)
        if decode_lanes:
            self._record_tpot(decode_lanes, produced)
            self.metrics.on_decode(produced)
            self.metrics.on_spec(proposed=proposed, accepted=accepted,
                                 produced=produced, lanes=decode_lanes)
        return produced

    def _rollback(self, lanes, pre_lens):
        """Trim every lane still in its slot back to its pre-round length,
        so the next round replays it (lanes: `(slot, req, ...)`)."""
        mgr = self.engine.manager
        for i, req, *_rest in lanes:
            if self.slots[i] is req:
                mgr.trim(req.seq_id, pre_lens[req.seq_id])

    def _commit_chunk(self, req: Request, n: int, slot: int, t_tok: float,
                      first_tok) -> None:
        """Advance a lane's chunked prefill by `n` committed tokens; on
        the round the FINAL chunk completes, emit the request's prefill
        event and commit its first token (ignored on a preempted
        re-admission whose pending token already exists)."""
        req._prefill_pos += n
        req._chunks += 1
        self.metrics.on_prefill_chunk(n)
        if req.prefilling:
            return                         # more chunks next round
        self.metrics.on_prefill_done()
        if _obs.enabled():
            self._obs_req(req, "prefill", t0=req._t_admit, t1=t_tok,
                          tokens=int(len(req._prefill_ctx)),
                          chunks=req._chunks)
        if req._last is None:              # fresh: the FIRST token
            self._commit_token(req, int(first_tok), slot, t_tok)

    def _commit_token(self, req: Request, tok: int, slot: int,
                      t_tok: float, obs_decode: bool = False):
        """Commit one sampled token: the ONE place the generated stream,
        pending token, TTFT stamp, stream callback and finish check
        advance together. `obs_decode`: a plain decode lane's commit,
        which gets its own timeline event."""
        req.generated.append(tok)
        req._last = tok
        self.tokens_committed += 1
        if req.t_first_token is None:
            req.t_first_token = t_tok
            self.metrics.on_first_token(req)
        if req.stream_cb is not None:
            req.stream_cb(req, tok)
        if obs_decode and _obs.enabled():
            self._obs_req(req, "decode", t0=t_tok, tokens=1,
                          total=len(req.generated))
        self._maybe_finish_on_token(req, tok, slot)

    def _maybe_finish_on_token(self, req: Request, tok: int, slot: int):
        if req.status.terminal:
            # a stream callback may cancel mid-commit: the slot and
            # blocks are already released — don't finish twice
            return
        sp = req.sampling
        if sp.eos_token_id is not None and tok == sp.eos_token_id:
            self._finish(req, RequestStatus.FINISHED, "eos", slot=slot)
        elif len(req.generated) >= sp.max_new_tokens:
            self._finish(req, RequestStatus.FINISHED, "max_new_tokens",
                         slot=slot)

    def _finish(self, req: Request, status: RequestStatus, reason: str,
                slot: Optional[int] = None, in_slot: bool = True):
        if in_slot:
            if slot is None:
                slot = self.slots.index(req)
            self.slots[slot] = None
            if status is not RequestStatus.FAILED:
                # a FAILED lane's KV may be poison (NaN isolation, engine
                # fault): never publish it into the shared tree
                self._publish_prefix(req)
            self.engine.manager.free(req.seq_id)
        else:
            # a WAITING request may hold imported KV (`import_session`)
            # that no slot path will ever free
            self._drop_resident_kv(req)
        self._release_spec(req)
        self._adapter_release(req)
        req.status = status
        req.finish_reason = reason
        req.t_finish = self._clock()
        self._finish_events += 1
        self.metrics.on_finish(req)
        if _obs.enabled():
            self._obs_req(req, f"terminal:{status.value}",
                          t0=req.t_finish, reason=reason,
                          tokens=len(req.generated))
            if status is RequestStatus.FAILED:
                _timeline.dump_flight(f"request_failed_{reason}")

    def _release_spec(self, req: Request):
        """Drop any speculative-proposer state for a request leaving the
        batch (finish, cancel, preempt). Idempotent; a failing proposer
        never raises into the serving path."""
        if self.spec is None:
            return
        try:
            self.spec.proposer.release(req.seq_id)
        except Exception:
            monitor.inc("serving.spec_release_errors")

    def _adapter_release(self, req: Request):
        """Drop a request's adapter lease on any exit from the batch or
        the queue (finish, cancel, preempt, release, failed admission).
        Idempotent: `_adapter_slot` is the lease token, cleared first;
        never raises into the serving path."""
        if req._adapter_slot is None or self._lora is None:
            return
        req._adapter_slot = None
        try:
            self._lora.release(req.adapter)
        except Exception:
            monitor.inc("serving.lora.release_errors")

    def _install_lane_adapters(self):
        """Push this round's lane -> adapter-slot vector: occupied lanes
        carry their request's leased slot, empty and base lanes the zero
        slot."""
        if self._set_lanes is None:
            return
        lanes = np.full((len(self.slots),), self._lora_zero, np.int32)
        for i, r in enumerate(self.slots):
            if r is not None and r._adapter_slot is not None:
                lanes[i] = r._adapter_slot
        self._set_lanes(lanes)
