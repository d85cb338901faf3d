"""Serving metrics: request/token counters, TTFT/TPOT latency (split into
prefix-cache hits and cold requests), queue depth and queued cost, batch
occupancy, KV utilization, preemptions, speculative acceptance, overload
shedding, isolated and step faults, stalls and engine restarts, the
per-tenant admission counters, the adapter pool's gauges with a
per-adapter TTFT histogram, and the prefill -> decode handoffs (count,
bytes, latency histogram) of disaggregated serving (the port of
`paddle_tpu/serving/metrics.py`).

Counters, gauges and histograms go to the port's monitor under the
`serving.` prefix, where the JAX package puts them (the prefix cache and
the block manager bump `serving.prefix_cache.*` at their source): the
step gauges rounded to 0.1, the TTFT / TPOT gauges published on the
first finish and every 16th, and the `serving.ttft_seconds`,
`ttft_cached_seconds`, `ttft_cold_seconds`, `tpot_seconds` and
per-adapter `serving.lora.ttft_seconds.<adapter>` histograms. The
per-request latency samples stay on the `ServingMetrics` instance, and
`summary()` reports the monitor's scalars with p50/p99 TTFT and TPOT.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np

from ..framework import monitor

__all__ = ["ServingMetrics"]

# bounded sliding window: a long-running server never grows its samples
_WINDOW = 4096
# the latency gauges' percentile passes are O(window): publish on the first
# finish, then every few
_PUBLISH_EVERY = 16

# counters summary() reports even before their first bump
_COUNTERS = ("requests_submitted", "requests_rejected", "requests_completed",
             "requests_cancelled", "requests_timed_out", "requests_failed",
             "preemptions", "isolated_faults", "prefill_tokens", "prefills",
             "decode_steps", "tokens_generated", "ragged_steps",
             "spec_steps", "spec_proposed_tokens", "spec_accepted_tokens",
             "shed_total", "step_faults", "stall_detections",
             "engine_restarts")


def _pct(samples, q: float) -> Optional[float]:
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, np.float64), q))


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else seconds * 1e3


class ServingMetrics:
    """Collector owned by one Scheduler (monitor names are global: reset
    with `reset_monitor()` when running several engines in-process)."""

    def __init__(self):
        self.ttft_s = deque(maxlen=_WINDOW)
        self.tpot_s = deque(maxlen=_WINDOW)
        # TTFT of requests admitted WITH a prefix-cache hit, and of the
        # rest: the side-by-side the prefix cache is judged on
        self.ttft_cached_s = deque(maxlen=_WINDOW)
        self.ttft_cold_s = deque(maxlen=_WINDOW)
        # per-round acceptance samples (speculative decoding), bounded
        # like the latency windows
        self.accept_rate = deque(maxlen=_WINDOW)
        self._occ_sum = 0.0
        self._steps = 0
        self._finishes = 0
        self._spec_steps = 0
        self._spec_produced = 0

    def reset_window(self):
        """Drop latency and acceptance samples and the occupancy and
        tokens-per-lane-step accumulators (e.g. at a warmup/measurement
        boundary) without touching the counters."""
        self.ttft_s.clear()
        self.tpot_s.clear()
        self.ttft_cached_s.clear()
        self.ttft_cold_s.clear()
        self.accept_rate.clear()
        self._occ_sum = 0.0
        self._steps = 0
        self._finishes = 0
        self._spec_steps = 0
        self._spec_produced = 0

    # ---- request lifecycle ----
    def on_submit(self):
        monitor.inc("serving.requests_submitted")

    def on_reject(self, reason: str):
        monitor.inc("serving.requests_rejected")
        monitor.inc(f"serving.rejected.{reason}")

    def on_shed(self, reason: str):
        """Overload shed at admission (status SHED): servable, but the
        watermark / deadline admission control turned it away."""
        monitor.inc("serving.shed_total")
        monitor.inc(f"serving.shed.{reason}")

    @staticmethod
    def shed_by_reason() -> dict:
        """Non-zero shed counts keyed by reason."""
        return {k[len("serving.shed."):]: v
                for k, v in monitor.snapshot("serving.shed.").items() if v}

    def on_preempt(self):
        monitor.inc("serving.preemptions")

    # ---- fault tolerance ----
    def on_isolated_fault(self, phase: str):
        """One request failed at the fault boundary (NaN lane, targeted
        `EngineStepError`, cache fault, failed probe replay); the other
        lanes kept serving."""
        monitor.inc("serving.isolated_faults")
        monitor.inc(f"serving.isolated_faults.{phase}")

    def on_step_fault(self, phase: str):
        """One UNattributed (transient) dispatch fault: nothing committed,
        no lane culpable; the whole step replays next round."""
        monitor.inc("serving.step_faults")
        monitor.inc(f"serving.step_faults.{phase}")

    def on_stall(self):
        monitor.inc("serving.stall_detections")

    def on_engine_restart(self, reason: str):
        monitor.inc("serving.engine_restarts")
        # reasons carry a phase suffix (step_faults:decode): keep the
        # leading class so the counter space stays bounded
        monitor.inc(f"serving.engine_restarts.{reason.split(':', 1)[0]}")

    def on_prefill_chunk(self, num_tokens: int):
        monitor.inc("serving.prefill_tokens", num_tokens)

    def on_prefill_done(self):
        monitor.inc("serving.prefills")

    def on_ragged_step(self, prefill_tokens: int, decode_lanes: int):
        """Composition of this round's one ragged dispatch."""
        monitor.set_gauge("serving.step_prefill_tokens", prefill_tokens)
        monitor.set_gauge("serving.step_decode_lanes", decode_lanes)

    def on_first_token(self, req):
        t = req.ttft()
        if t is not None:
            self.ttft_s.append(t)
            monitor.observe("serving.ttft_seconds", t)
            if req._prefix_hit_tokens > 0:
                self.ttft_cached_s.append(t)
                monitor.observe("serving.ttft_cached_seconds", t)
            else:
                self.ttft_cold_s.append(t)
                monitor.observe("serving.ttft_cold_seconds", t)
            if req.adapter:
                # per-adapter TTFT: an adapter whose requests keep missing
                # the pool shows up as a fat histogram here
                monitor.observe(f"serving.lora.ttft_seconds.{req.adapter}",
                                t)

    # ---- shared-prefix radix cache ----
    def on_prefix_lease(self, hit_tokens: int):
        """One admission through the radix prefix cache (`hit_tokens`
        context tokens served from cache; 0 = miss). The hit / miss /
        eviction / COW counters are bumped at their source; this derives
        the hit-rate gauge."""
        hits = monitor.get("serving.prefix_cache.hits")
        miss = monitor.get("serving.prefix_cache.misses")
        if hits + miss:
            monitor.set_gauge("serving.prefix_cache.hit_rate_pct",
                              round(hits / (hits + miss) * 100.0, 1))

    # ---- multi-tenant SLO classes ----
    def on_tenant_admit(self, tenant: str):
        monitor.inc(f"serving.tenant.{tenant}.admitted")

    def on_tenant_deferred(self, tenant: str, reason: str):
        """A tenant's head-of-queue request was passed over this
        admission round (kv_quota / kv_reserve) WITHOUT blocking other
        tenants."""
        monitor.inc(f"serving.tenant.{tenant}.deferred.{reason}")

    def on_finish(self, req):
        from .scheduler import RequestStatus

        name = {RequestStatus.FINISHED: "serving.requests_completed",
                RequestStatus.CANCELLED: "serving.requests_cancelled",
                RequestStatus.TIMED_OUT: "serving.requests_timed_out",
                RequestStatus.FAILED: "serving.requests_failed"}.get(
                    req.status)
        if name:
            monitor.inc(name)
        t = req.tpot()
        if t is not None:
            self.tpot_s.append(t)
            monitor.observe("serving.tpot_seconds", t)
        self._finishes += 1
        if self._finishes == 1 or self._finishes % _PUBLISH_EVERY == 0:
            self._publish_latency()

    def on_handoff(self, nbytes: int, wall_s: float):
        """One prefill -> decode session handoff landed
        (`serving/disagg.py`): `nbytes` of KV payload moved (slabs and
        scale planes), `wall_s` from extract to inject. The counters size
        the link a deployment needs; the histogram is the handoff-latency
        surface."""
        monitor.inc("serving.handoff.count")
        monitor.inc("serving.handoff.bytes", int(nbytes))
        monitor.inc("serving.handoff.wall_ms", wall_s * 1e3)
        monitor.observe("serving.handoff.latency_seconds", wall_s)

    # ---- step-level ----
    def on_decode(self, tokens: int):
        monitor.inc("serving.decode_steps")
        monitor.inc("serving.tokens_generated", tokens)

    def on_spec(self, proposed: int, accepted: int, produced: int,
                lanes: int):
        """One speculative verify round: `proposed` draft tokens offered,
        `accepted` matched the target, `produced` tokens committed
        (accepted + one bonus/correction per lane) across `lanes` decode
        lanes. `serving.spec_tokens_per_lane_step` estimates the speedup:
        plain decoding commits exactly 1 token per lane per step."""
        monitor.inc("serving.spec_steps")
        monitor.inc("serving.spec_proposed_tokens", proposed)
        monitor.inc("serving.spec_accepted_tokens", accepted)
        self._spec_steps += max(lanes, 1)
        self._spec_produced += produced
        if proposed:
            self.accept_rate.append(accepted / proposed)
        tot_p = monitor.get("serving.spec_proposed_tokens")
        tot_a = monitor.get("serving.spec_accepted_tokens")
        if tot_p:
            monitor.set_value("serving.spec_acceptance_pct",
                              round(tot_a / tot_p * 100.0, 1))
        monitor.set_value(
            "serving.spec_tokens_per_lane_step",
            round(self._spec_produced / max(self._spec_steps, 1), 2))

    def on_step(self, occupancy: float, kv_utilization: float,
                queue_depth: int, decoded: bool = True):
        # occupancy averages over decode steps only
        if decoded:
            self._steps += 1
            self._occ_sum += occupancy
            monitor.set_gauge("serving.batch_occupancy_pct",
                              round(occupancy * 100.0, 1))
            monitor.set_gauge("serving.batch_occupancy_avg_pct",
                              round(self._occ_sum / self._steps * 100.0, 1))
        monitor.set_gauge("serving.kv_utilization_pct",
                          round(kv_utilization * 100.0, 1))
        monitor.set_max("serving.kv_utilization_peak_pct",
                        round(kv_utilization * 100.0, 1))
        monitor.set_gauge("serving.queue_depth", queue_depth)
        monitor.set_max("serving.queue_depth_peak", queue_depth)

    def gauge_queue(self, depth: int, queued_cost: Optional[int] = None):
        """Queue depth and, when given, the queued cost: the
        `max_new_tokens`-weighted backlog the cost watermark and the
        deadline-shed estimate latch on."""
        monitor.set_gauge("serving.queue_depth", depth)
        monitor.set_max("serving.queue_depth_peak", depth)
        if queued_cost is not None:
            monitor.set_gauge("serving.queued_cost", queued_cost)
            monitor.set_max("serving.queued_cost_peak", queued_cost)

    def _publish_latency(self):
        for name, val in (("serving.ttft_p50_ms", _pct(self.ttft_s, 50)),
                          ("serving.ttft_p99_ms", _pct(self.ttft_s, 99)),
                          ("serving.prefix_cache.ttft_cached_p50_ms",
                           _pct(self.ttft_cached_s, 50)),
                          ("serving.prefix_cache.ttft_cold_p50_ms",
                           _pct(self.ttft_cold_s, 50)),
                          ("serving.tpot_mean_ms",
                           float(np.mean(self.tpot_s)) if self.tpot_s
                           else None)):
            if val is not None:
                monitor.set_gauge(name, round(val * 1e3, 3))

    # ---- quantized serving ----
    def on_quant(self, info: dict):
        """Publish the engine's quantization mode (`serving.quant.
        quant_summary`): weight bits, KV bits and the per-token KV bytes
        (`serving.quant.{wbits,kv_bits}`, `serving.kv_bytes_per_token`).
        Called once when the scheduler binds an engine, never on the step
        path."""
        monitor.set_gauge("serving.quant.wbits", int(info.get("wbits", 16)))
        monitor.set_gauge("serving.quant.kv_bits",
                          int(info.get("kv_bits", 16)))
        bpt = info.get("kv_bytes_per_token")
        if bpt is not None:
            monitor.set_gauge("serving.kv_bytes_per_token",
                              round(float(bpt), 1))

    # ---- multi-LoRA serving ----
    def on_lora(self, info: dict):
        """Publish the adapter pool's shape (`LoRAEngine.lora_info`): slot
        count, residency, registry size and padded rank, as the
        `serving.lora.{pool_slots,resident_adapters,registered_adapters,
        rank_max}` gauges. Bind-time, like `on_quant`; the pool bumps
        `serving.lora.{miss_loads,evictions}` at their source."""
        monitor.set_gauge("serving.lora.pool_slots",
                          int(info.get("pool_slots", 0)))
        monitor.set_gauge("serving.lora.resident_adapters",
                          int(info.get("resident_adapters", 0)))
        monitor.set_gauge("serving.lora.registered_adapters",
                          int(info.get("registered", 0)))
        monitor.set_gauge("serving.lora.rank_max",
                          int(info.get("rank_max", 0)))

    # ---- reporting ----
    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {f"serving.{n}": 0 for n in _COUNTERS}
        # the scalar slice: the histogram expansion stays out, as in JAX
        out.update(monitor.snapshot("serving.", include_histograms=False))
        out["serving.ttft_p50_ms"] = _ms(_pct(self.ttft_s, 50))
        out["serving.ttft_p99_ms"] = _ms(_pct(self.ttft_s, 99))
        out["serving.tpot_p50_ms"] = _ms(_pct(self.tpot_s, 50))
        out["serving.tpot_mean_ms"] = _ms(
            float(np.mean(self.tpot_s)) if self.tpot_s else None)
        if self.ttft_cached_s or self.ttft_cold_s:
            for name, window in (("cached", self.ttft_cached_s),
                                 ("cold", self.ttft_cold_s)):
                for q in (50, 99):
                    out[f"serving.prefix_cache.ttft_{name}_p{q}_ms"] = \
                        _ms(_pct(window, q))
        return out

    @staticmethod
    def reset_monitor():
        """Zero every serving.* counter, gauge and histogram (tests,
        several engines); the names stay in the monitor at 0."""
        monitor.reset_prefix("serving.")
