"""The monitor and the serving metrics on both packages: the port's
`framework/monitor.py` op for op against the JAX package's (counters,
gauges, high-water marks, histograms, snapshots, the Prometheus text,
`reset(name)` / `reset_prefix` / `reset_all`, the mesh aggregation); a
scripted `ServingMetrics` run whose `snapshot("serving.")` — gauges,
counters and histogram buckets — is equal in both packages, and stays
equal after `reset_monitor()`, which zeroes and keeps every name. Then
the four swallowed-error counters only the port keeps (a failing
reclaimer or prefix publish, a failing prefix-stream hook, a failing KV
drop), one case each."""
from types import SimpleNamespace

import numpy as np
import pytest

from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.serving import scheduler as jscheduler
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.serving import metrics as tmetrics
from paddle_tpu_torch.serving import scheduler as tscheduler

MONITORS = (jmonitor, tmonitor)


@pytest.fixture
def fresh_monitors(monkeypatch):
    """Empty registries in both packages for the test (restored after)."""
    for m in MONITORS:
        monkeypatch.setattr(m, "_registry", {})
        monkeypatch.setattr(m, "_histograms", {})


def _monitor_script(m):
    out = []
    c = m.register_counter("mt.c")
    out.append(type(c).__name__)
    out.append(m.counter("mt.c") is c)
    out += [m.inc("mt.c"), m.inc("mt.c", 4), m.inc("mt.f", 0.25)]
    m.set_value("mt.v", 7)
    m.set_gauge("mt.g", 3.5)
    m.set_gauge("mt.c2", 1)
    m.register_counter("mt.c2", kind="gauge")
    out += [m.set_max("mt.peak", 5), m.set_max("mt.peak", 2),
            m.set_max("mt.peak", 9)]
    h = m.histogram("mt.h", buckets=(1.0, 10.0, 0.1))
    out.append(h.buckets)
    for v in (0.05, 0.5, 5.0, 50.0, 1.0):
        m.observe("mt.h", v)
    for v in (0.002, 0.2, 2.0, 20.0):
        m.observe("mt.d", v)
    with pytest.raises(ValueError):
        m.histogram("mt.h", buckets=(2.0,))
    out += [m.get("mt.c"), m.get("mt.missing"), m.get("mt.peak")]
    out.append({k: v for k, v in m.get_all().items() if k.startswith("mt.")})
    out.append(m.snapshot("mt."))
    out.append(m.snapshot("mt.", include_histograms=False))
    out.append(m.render_prometheus("mt."))
    m.reset("mt.c")
    m.reset("mt.h")
    out.append(m.snapshot("mt."))
    m.reset_prefix("mt.d")
    m.reset_prefix("mt.p")
    out.append(m.snapshot("mt."))
    agg = m.aggregate_mesh(
        "mt.", snapshots=[{"mt.c": 1, "mt.wall": 10.0},
                          {"mt.c": 2, "mt.wall": 30.0, "mt.flag": True}],
        step_wall_key="mt.wall")
    out.append(agg)
    out.append(m.snapshot("mesh."))
    out.append(m.aggregate_mesh("mt.", snapshots=[{"mt.c": 1}])
               ["straggler_host"])
    m.reset_all()
    out.append(m.snapshot())
    cnt, hist = m.Counter("x"), m.Histogram("y", (1.0,))
    cnt.inc(3)
    cnt.set_max(2)
    hist.observe(0.5)
    hist.observe(4.0)
    out += [cnt.get(), hist.snapshot()]
    cnt.reset()
    hist.reset()
    out += [cnt.get(), hist.snapshot()]
    return out


def test_monitor_surface_matches_jax_op_for_op(fresh_monitors):
    want, got = (_monitor_script(m) for m in MONITORS)
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, w, g)
    assert set(tmonitor.__all__) == set(jmonitor.__all__)


class _Req(SimpleNamespace):
    def ttft(self):
        return self.t_first

    def tpot(self):
        return self.t_tok


def _serving_script(metrics_mod, sched_mod):
    M = metrics_mod.ServingMetrics()
    mon = jmonitor if metrics_mod is jmetrics else tmonitor
    St = sched_mod.RequestStatus
    for _ in range(3):
        M.on_submit()
    M.on_reject("prompt_too_long")
    M.on_shed("queue_depth")
    M.on_preempt()
    M.on_isolated_fault("decode")
    M.on_step_fault("ragged")
    M.on_stall()
    M.on_engine_restart("step_faults:decode")
    M.on_prefill_chunk(12)
    M.on_prefill_done()
    M.on_ragged_step(12, 3)
    M.on_tenant_admit("a")
    M.on_tenant_deferred("a", "kv_quota")
    mon.inc("serving.prefix_cache.hits", 3)
    mon.inc("serving.prefix_cache.misses", 4)
    M.on_prefix_lease(8)
    M.on_quant({"wbits": 8, "kv_bits": 8, "kv_bytes_per_token": 1234.56})
    M.on_lora({"pool_slots": 4, "resident_adapters": 2, "registered": 3,
               "rank_max": 8})
    M.on_handoff(4096, 0.0031)
    statuses = (St.FINISHED, St.CANCELLED, St.TIMED_OUT, St.FAILED)
    for i in range(34):
        req = _Req(t_first=0.0007 * (i + 1), t_tok=0.0123 + 0.001 * i,
                   _prefix_hit_tokens=8 * (i % 3 == 0),
                   adapter=("lora_a" if i % 5 == 0 else None),
                   status=statuses[i % 4])
        M.on_first_token(req)
        M.on_decode(2 + i % 3)
        M.on_step(occupancy=(i % 7) / 7, kv_utilization=(i % 11) / 11,
                  queue_depth=i % 5, decoded=i % 4 != 3)
        M.gauge_queue(i % 6, queued_cost=10 * i)
        M.on_spec(proposed=4, accepted=i % 5, produced=i % 5 + 1,
                  lanes=2)
        M.on_finish(req)
    return M, mon


def test_serving_metrics_snapshot_equal_and_survives_reset(fresh_monitors):
    (jm, jmon), (tm, tmon) = (_serving_script(jmetrics, jscheduler),
                              _serving_script(tmetrics, tscheduler))
    want, got = jmon.snapshot("serving."), tmon.snapshot("serving.")
    assert got == want
    # the probe that found the fault: the step gauges are in the monitor
    tm.on_step(occupancy=0.5, kv_utilization=0.25, queue_depth=3)
    assert tmon.get("serving.queue_depth") == 3
    assert tmon.get("serving.batch_occupancy_pct") == 50.0
    for name in ("ttft_seconds", "ttft_cached_seconds", "ttft_cold_seconds",
                 "tpot_seconds", "lora.ttft_seconds.lora_a"):
        assert got[f"serving.{name}_count"] > 0, name
    for name in ("ttft_p50_ms", "tpot_mean_ms", "prefix_cache.hit_rate_pct",
                 "step_prefill_tokens", "kv_utilization_peak_pct"):
        assert got[f"serving.{name}"] > 0, name
    assert tmetrics.ServingMetrics.summary(tm)["serving.queue_depth"] == 3
    jmetrics.ServingMetrics.reset_monitor()
    tmetrics.ServingMetrics.reset_monitor()
    after = tmon.snapshot("serving.")
    assert after == jmon.snapshot("serving.")
    assert set(after) == set(got) and not any(after.values())


def test_reset_callers_zero_one_name_or_a_prefix(fresh_monitors):
    """`reset(name)` zeroes one counter, not every name it prefixes (the
    engine-call resets of the smoke run); `reset_prefix` zeroes a family
    and keeps it."""
    for n in ("serving.ragged_steps", "serving.ragged_steps_x", "fleet.a"):
        tmonitor.inc(n, 2)
    tmonitor.reset("serving.ragged_steps")
    assert tmonitor.get("serving.ragged_steps_x") == 2
    tmonitor.reset_prefix("fleet.")
    assert tmonitor.snapshot("fleet.") == {"fleet.a": 0}


# ---------------------------------------------------------------------------
# the port's swallowed-error counters
# ---------------------------------------------------------------------------

class _Raises:
    def __getattr__(self, name):
        def fail(*a, **kw):
            raise RuntimeError(f"{name} failed")
        return fail


def test_failing_reclaimer_is_counted(fresh_monitors):
    from paddle_tpu_torch.inference.cache import BlockCacheManager

    mgr = BlockCacheManager(4, 4, 4)
    mgr.set_reclaimer(_Raises())
    assert mgr.reclaimable_blocks() == 0
    mgr.allocate(0, 16)
    with pytest.raises(Exception):
        mgr.allocate(1, 4)           # evict raises, then the pool is full
    assert tmonitor.get("serving.prefix_cache.reclaimer_errors") == 2


def _frontend():
    from paddle_tpu_torch.serving import MLPLMEngine, ServingFrontend

    eng = MLPLMEngine(vocab_size=64, hidden=16, max_batch_size=2,
                      num_blocks=16, block_size=4, max_blocks_per_seq=4,
                      device="cpu")
    return ServingFrontend(eng, prefix_cache=True)


def test_failing_prefix_publish_is_counted(fresh_monitors):
    fe = _frontend()
    fe.scheduler.prefix_cache.publish = _Raises().publish
    h = fe.submit(np.arange(1, 10, dtype=np.int32), max_new_tokens=2)
    fe.run_until_idle()
    assert h.status.value == "finished"
    assert tmonitor.get("serving.prefix_cache.publish_errors") == 1


def test_failing_prefix_stream_hook_is_counted(fresh_monitors):
    fe = _frontend()
    fe.scheduler.prefix_stream_hook = _Raises().hook
    h = fe.submit(np.arange(1, 10, dtype=np.int32), max_new_tokens=2)
    fe.run_until_idle()
    assert h.status.value == "finished"
    assert tmonitor.get("serving.prefix_stream_hook_errors") == 1


def test_failing_kv_drop_is_counted(fresh_monitors, monkeypatch):
    fe = _frontend()
    sched = fe.scheduler
    monkeypatch.setattr(sched.engine.manager, "seq_blocks",
                        _Raises().seq_blocks)
    req = SimpleNamespace(_kv_resident=True, seq_id=3)
    sched._drop_resident_kv(req)
    assert not req._kv_resident
    assert tmonitor.get("serving.kv_migrate.drop_errors") == 1
