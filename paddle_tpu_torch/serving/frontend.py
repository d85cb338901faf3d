"""ServingFrontend — submit/stream/cancel over the continuous-batching
scheduler (the port of `paddle_tpu/serving/frontend.py`'s core).

Callers submit token prompts and get back a `RequestHandle` they can
poll, stream or cancel. Over-capacity submissions come back REJECTED with
a reason, overload watermarks SHED, expired deadlines TIMED_OUT, isolated
engine faults FAILED: every submitted request reaches a terminal status.
The frontend is driven synchronously: `step()` advances one scheduling
round; `stream()` and `run_until_idle()` drive it for you and, when no
watchdog is installed, raise a typed `EngineStalled` (never spin) after
`stall_after` consecutive zero-progress steps. `release`, `resubmit`
and `import_session` move requests between frontends (a session's KV
travels as a `KVBlockPayload`, `inference/kv_migrate.py`).
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence

from .fault_tolerance import AdmissionConfig, EngineStalled, WatchdogConfig
from .metrics import ServingMetrics
from .scheduler import Request, RequestStatus, SamplingParams, Scheduler
from .slo import DEFAULT_TENANT, SLOConfig

__all__ = ["RequestHandle", "ServingFrontend"]


class RequestHandle:
    """Caller's view of one request."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def request_id(self) -> int:
        return self._req.req_id

    @property
    def status(self) -> RequestStatus:
        return self._req.status

    @property
    def finished(self) -> bool:
        return self._req.status.terminal

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    @property
    def tokens(self) -> List[int]:
        return list(self._req.generated)

    @property
    def num_preemptions(self) -> int:
        return self._req.num_preemptions

    @property
    def replica_id(self) -> Optional[str]:
        """The fleet replica serving this request now (`serving/fleet.py`
        placement); None under a standalone frontend."""
        return self._req.replica_id

    @property
    def num_relocations(self) -> int:
        """How often a replica death or drain moved this request to
        another replica (each move also lands a `relocated` event on its
        timeline)."""
        return self._req.num_relocations

    def timeline(self) -> list:
        """This request's recorded timeline events (oldest first) as
        dicts: queued -> admitted -> prefill -> decode / verify rounds
        -> (preempted / relocated ->) terminal. Empty unless
        `observability.enable()` is on; a ring left from an earlier,
        since-disabled session is not read."""
        from .. import observability as _obs
        from ..observability import timeline as _timeline

        if not _obs.enabled():
            return []
        return [e.as_dict() for e in _timeline.events()
                if e.req_id == self._req.req_id]

    def ttft_ms(self) -> Optional[float]:
        t = self._req.ttft()
        return None if t is None else t * 1e3

    def tpot_ms(self) -> Optional[float]:
        t = self._req.tpot()
        return None if t is None else t * 1e3

    def __repr__(self):
        return (f"RequestHandle(id={self.request_id}, "
                f"status={self.status.value}, "
                f"tokens={len(self._req.generated)}, "
                f"reason={self.finish_reason})")


class ServingFrontend:
    def __init__(self, engine, metrics: Optional[ServingMetrics] = None,
                 max_queue: int = 256,
                 default_timeout_s: Optional[float] = None,
                 stall_after: int = 512,
                 prefill_chunk_tokens: int = 32,
                 spec=None,
                 clock=time.perf_counter,
                 admission: Optional[AdmissionConfig] = None,
                 watchdog: Optional[WatchdogConfig] = None,
                 engine_factory=None,
                 prefix_cache: bool = False,
                 slo: Optional[SLOConfig] = None):
        """`engine`: an `EngineCore` (e.g. `LlamaInferenceEngine`, whose
        `device=None` means the CUDA card). `prefill_chunk_tokens`:
        per-step pending-prompt token budget for chunked prefill.
        `spec`: optional `SpecDecodeConfig` enabling speculative decoding
        (the engine then serves through `verify_step`).
        `stall_after`: with no watchdog, `run_until_idle`/`stream` raise
        `EngineStalled` after this many consecutive zero-progress steps.
        `clock`: time source for deadlines, latency stamps and stall
        detection, shared with the scheduler.

        `admission`: optional `AdmissionConfig` (overload load shedding:
        watermarks and deadline-aware early rejection). `watchdog` +
        `engine_factory`: optional `WatchdogConfig` (stall detection and
        bounded engine restarts; the factory rebuilds an identically
        configured engine, e.g. `MLPLMEngine.respawn`; a factory alone
        opts into the default `WatchdogConfig`). `prefix_cache`: the
        shared-prefix radix cache — repeated prompts and sessions skip
        the cached part of prefill. `slo`: optional `SLOConfig` of
        per-tenant quotas, reserves, admission weights and watermark
        tiers; submissions then carry `tenant=`."""
        self.metrics = metrics or ServingMetrics()
        self._clock = clock
        self.scheduler = Scheduler(engine, metrics=self.metrics,
                                   max_queue=max_queue,
                                   prefill_chunk_tokens=prefill_chunk_tokens,
                                   spec=spec, clock=clock,
                                   admission=admission, watchdog=watchdog,
                                   engine_factory=engine_factory,
                                   prefix_cache=prefix_cache, slo=slo)
        self.default_timeout_s = default_timeout_s
        self.stall_after = stall_after

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               eos_token_id: Optional[int] = None,
               timeout_s: Optional[float] = None,
               stream_cb=None, seed: int = 0,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None) -> RequestHandle:
        """Enqueue a generation request. NEVER raises on load conditions:
        a request that cannot be served comes back already terminal with
        `finish_reason` in {prompt_too_long, queue_full, empty_prompt,
        unknown_adapter, no_adapter_pool} (REJECTED) or a watermark /
        deadline reason (SHED). `tenant` names the request's SLO class
        when an `SLOConfig` is installed (unknown or None -> the default
        class). `adapter` names a registered LoRA adapter of a multi-LoRA
        engine (`serving/lora.py`); when the SLO config has a class named
        after the adapter (`slo_for_adapters`) and no tenant was given,
        the adapter IS the tenant."""
        timeout_s = self.default_timeout_s if timeout_s is None else timeout_s
        now = self._clock()
        deadline = None if timeout_s is None else now + timeout_s
        sp = SamplingParams(max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eos_token_id=eos_token_id, seed=seed)
        cb = None
        if stream_cb is not None:
            cb = lambda req, tok, _cb=stream_cb: _cb(tok)  # noqa: E731
        if adapter is not None and (tenant is None
                                    or tenant == DEFAULT_TENANT):
            slo = self.scheduler._slo
            if slo is not None and adapter in slo.classes:
                tenant = adapter
        req = Request(prompt_ids, sampling=sp, deadline=deadline,
                      stream_cb=cb, tenant=tenant, adapter=adapter)
        self.scheduler.submit(req, now=now)
        return RequestHandle(req)

    def cancel(self, handle: RequestHandle) -> bool:
        return self.scheduler.cancel(handle._req)

    # ---- moving requests between frontends ----
    def in_flight(self) -> List[Request]:
        """Non-terminal requests this frontend owns (admission order,
        then the queue)."""
        return self.scheduler.in_flight()

    def release(self, handle_or_req) -> bool:
        """Take a non-terminal request OUT of this frontend without a
        terminal status (blocks freed, tokens so far kept, status
        PREEMPTED), so it can be re-submitted elsewhere. Accepts a
        `RequestHandle` or a `Request`."""
        req = getattr(handle_or_req, "_req", handle_or_req)
        return self.scheduler.release(req)

    def resubmit(self, req: Request) -> Request:
        """Route an existing `Request` through this frontend's admission
        (`submit` builds fresh requests). The caller resets it to QUEUED
        with its committed tokens folded into the prompt; admission may
        still reject or shed it (a terminal status, never an
        exception)."""
        return self.scheduler.submit(req, now=self._clock())

    def import_session(self, req: Request, payload) -> Request:
        """Admit an existing `Request` whose context KV arrives as a
        migrated `KVBlockPayload` instead of through prefill
        (`Scheduler.import_session`): load conditions come back as a
        terminal status, migration mismatches and pool exhaustion raise
        typed."""
        return self.scheduler.import_session(req, payload,
                                             now=self._clock())

    def step(self) -> int:
        """Advance one scheduling round; returns tokens produced."""
        return self.scheduler.step()

    def _check_stalled(self):
        sch = self.scheduler
        if sch.watchdog_active:
            # the watchdog owns stall recovery (restart, then typed
            # failure once its budget is gone); raising here on a tighter
            # stall_after would preempt the restart the caller configured
            return
        if self.stall_after and not sch.idle \
                and sch.zero_progress_steps >= self.stall_after:
            from .. import observability as _obs
            from ..observability import timeline as _timeline

            if _obs.enabled():
                # the rounds that led to the wedge, on disk before the
                # typed raise unwinds the driver loop
                _timeline.dump_flight("engine_stalled")
            mgr = sch.engine.manager
            raise EngineStalled(
                sch.zero_progress_steps,
                f"running={sch.num_running} queued={len(sch.waiting)} "
                f"free_blocks={mgr.free_blocks}/{mgr.num_blocks}")

    def run_until_idle(self, max_steps: int = 100000) -> int:
        """Drive until every submitted request is terminal. Returns steps
        taken. Without a watchdog a wedged engine raises `EngineStalled`
        (with one, the watchdog restarts the engine, and fails every
        request typed once its budget is gone); `max_steps` bounds
        runaway loops (a bug, so it raises)."""
        for n in range(max_steps):
            if self.scheduler.idle:
                return n
            self.step()
            self._check_stalled()
        if not self.scheduler.idle:
            raise RuntimeError(f"not idle after {max_steps} steps")
        return max_steps

    def stream(self, handle: RequestHandle,
               max_steps: int = 100000) -> Iterator[int]:
        """Yield tokens for `handle` as they are produced, driving the
        scheduler; other in-flight requests advance on the same steps."""
        seen = 0
        for _ in range(max_steps):
            toks = handle._req.generated
            while seen < len(toks):
                yield toks[seen]
                seen += 1
            if handle.finished:
                return
            self.step()
            self._check_stalled()
        raise RuntimeError(f"stream not finished after {max_steps} steps")

    def summary(self) -> dict:
        return self.metrics.summary()
