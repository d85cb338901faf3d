"""The serving fault-tolerance scenarios of `tests/test_serving_faults.py`
on both packages: overload admission control (watermark hysteresis, the
exact-boundary contract, deadline-aware shedding), request fault
isolation (NaN lanes, targeted `EngineStepError`, cache faults, probe
attribution, transient retry) and the engine watchdog (stall detection,
bounded restarts, budget exhaustion), each driven through its own
package's `faults` registry with zero sleeps, on each package's
`MLPLMEngine` (the port's on the CPU). Every scenario gives the same
token streams, statuses, finish reasons, counters and leak counts in
both packages, and holds the JAX suite's own assertions."""
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu.serving as jserving
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import scheduler as jscheduler
from paddle_tpu.serving.fault_tolerance import OverloadController as JOC
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import scheduler as tscheduler
from paddle_tpu_torch.serving.fault_tolerance import OverloadController as TOC
from torch_threads import one_thread  # noqa: F401

VOCAB = 64


def _pkg(name, serving, monitor, faults, scheduler, controller,
         **engine_kw):
    def engine(max_batch=4, num_blocks=48, block_size=4,
               max_blocks_per_seq=8):
        return serving.MLPLMEngine(
            vocab_size=VOCAB, hidden=16, max_batch_size=max_batch,
            num_blocks=num_blocks, block_size=block_size,
            max_blocks_per_seq=max_blocks_per_seq, **engine_kw)

    return SimpleNamespace(name=name, s=serving, monitor=monitor,
                           faults=faults, Request=scheduler.Request,
                           SamplingParams=scheduler.SamplingParams,
                           OverloadController=controller, engine=engine)


JAX = _pkg("jax", jserving, jmonitor, jfaults, jscheduler, JOC)
PORT = _pkg("port", tserving, tmonitor, tfaults, tscheduler, TOC,
            device="cpu")
PKGS = (JAX, PORT)


def _gauge(p, fe, name):
    """A gauge: the JAX package keeps it in its monitor, the port on the
    metrics instance (`summary()`)."""
    if p is JAX:
        return jmonitor.get(name)
    return fe.summary().get(name, 0)


@pytest.fixture(autouse=True)
def _fresh_state():
    for p in PKGS:
        p.s.ServingMetrics.reset_monitor()
        p.faults.clear()
    yield
    for p in PKGS:
        p.faults.clear()


def both(scenario, *args):
    """Run `scenario(pkg, *args)` on each package (counters and fault
    registries fresh for each) and assert the outcomes are equal;
    returns the JAX package's."""
    out = {}
    for p in PKGS:
        p.s.ServingMetrics.reset_monitor()
        p.faults.clear()
        out[p.name] = scenario(p, *args)
        p.faults.clear()
    assert out["port"] == out["jax"]
    return out["jax"]


def prompts(n, seed=0, lo=2, hi=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def run_trace(fe, plist, max_new=6, max_steps=2000):
    hs = [fe.submit(p, max_new_tokens=max_new) for p in plist]
    fe.run_until_idle(max_steps=max_steps)
    return hs


def outcome(hs):
    return [(h.tokens, h.status.value, h.finish_reason) for h in hs]


def leaks(fe):
    """(leaked blocks, blocks leased beyond the guard)."""
    mgr = fe.scheduler.engine.manager
    return (fe.scheduler.kv_leaked_blocks(),
            mgr.num_blocks - 1 - mgr.free_blocks)


COUNTERS = ("shed_total", "shed.queue_depth", "shed.kv_pressure",
            "shed.deadline_unmeetable", "isolated_faults",
            "isolated_faults.decode", "isolated_faults.verify",
            "isolated_faults.cache", "step_faults", "engine_restarts",
            "stall_detections", "requests_failed", "requests_completed")


def counters(p):
    return {c: p.monitor.get(f"serving.{c}") for c in COUNTERS}


# ---------------------------------------------------------------------------
# Admission control / load shedding
# ---------------------------------------------------------------------------

def _controller_probes(p, case):
    s = p.s
    if case == "queue":
        c = p.OverloadController(s.AdmissionConfig(queue_high=4,
                                                   queue_low=2))
        return [c.shed_reason(queue_depth=d, queued_cost=0, req_cost=1,
                              kv_utilization=0.0, deadline=None, now=0.0,
                              tpot_s=None, lanes=4)
                for d in (3, 4, 3, 2, 3)]
    if case == "cost":
        c = p.OverloadController(s.AdmissionConfig(cost_high=100,
                                                   cost_low=40))
        return [c.shed_reason(queue_depth=0, queued_cost=q, req_cost=r,
                              kv_utilization=0.0, deadline=None, now=0.0,
                              tpot_s=None, lanes=4)
                for q, r in ((0, 500), (99, 4), (100, 1), (50, 1),
                             (40, 500))]
    if case == "kv":
        c = p.OverloadController(s.AdmissionConfig(kv_high=0.9,
                                                   kv_low=0.5))
        return [c.shed_reason(queue_depth=0, queued_cost=0, req_cost=1,
                              kv_utilization=u, deadline=None, now=0.0,
                              tpot_s=None, lanes=4)
                for u in (0.89, 0.9, 0.6, 0.5)]
    c = p.OverloadController(s.AdmissionConfig(deadline_aware=True))
    kw = dict(queue_depth=0, kv_utilization=0.0, now=10.0, lanes=4,
              queued_cost=80, req_cost=10)
    return [c.shed_reason(tpot_s=t, deadline=d, **kw)
            for t, d in ((0.01, 10.2), (0.01, 10.5), (None, 10.2))]


@pytest.mark.parametrize("case,want", [
    ("queue", [None, "queue_depth", "queue_depth", None, None]),
    ("cost", [None, None, "queue_cost", "queue_cost", None]),
    ("kv", [None, "kv_pressure", "kv_pressure", None]),
    ("deadline", ["deadline_unmeetable", None, None])])
def test_overload_controller_watermarks(case, want):
    """Exact boundaries and hysteresis of every watermark latch (the
    cost latch tracks the backlog only), and the deadline estimate."""
    assert both(_controller_probes, case) == want


def test_admission_config_validation():
    for p in PKGS:
        with pytest.raises(ValueError):
            p.s.AdmissionConfig(queue_high=4, queue_low=9)
        cfg = p.s.AdmissionConfig(queue_high=8, cost_high=100, kv_high=0.9)
        assert (cfg.queue_low, cfg.cost_low) == (4, 50)
        assert cfg.kv_low == pytest.approx(0.75)
        with pytest.raises(ValueError):
            p.s.WatchdogConfig(stall_steps=0)


def _queue_shed_then_recover(p):
    fe = p.s.ServingFrontend(p.engine(max_batch=1, num_blocks=32),
                             admission=p.s.AdmissionConfig(queue_high=3,
                                                           queue_low=1))
    hs = [fe.submit([1, 2, 3], max_new_tokens=4) for _ in range(3)]
    shed = [fe.submit([1, 2, 3], max_new_tokens=4) for _ in range(2)]
    queued = [h.status.value for h in hs]
    fe.run_until_idle(max_steps=300)
    late = fe.submit([1, 2, 3], max_new_tokens=2)
    late_status = late.status.value
    fe.run_until_idle(max_steps=100)
    return (queued, outcome(hs + shed + [late]), late_status, counters(p),
            leaks(fe))


def test_queue_shed_then_recover():
    queued, out, late_status, c, lk = both(_queue_shed_then_recover)
    assert queued == ["queued"] * 3
    assert [o[1:] for o in out[3:5]] == [("shed", "queue_depth")] * 2
    assert all(o[1] == "finished" for o in out[:3] + out[5:])
    assert late_status != "shed"
    assert c["shed_total"] == 2 and c["shed.queue_depth"] == 2
    assert lk == (0, 0)


def _kv_pressure_shed(p):
    eng = p.engine(max_batch=2, num_blocks=8)
    fe = p.s.ServingFrontend(
        eng, admission=p.s.AdmissionConfig(kv_high=0.6, kv_low=0.2))
    hog = fe.submit(list(range(1, 20)), max_new_tokens=8)
    fe.step()
    util = eng.manager.utilization()
    shed = fe.submit([1, 2], max_new_tokens=2)
    fe.run_until_idle(max_steps=200)
    ok = fe.submit([1, 2], max_new_tokens=2)
    ok_status = ok.status.value
    fe.run_until_idle(max_steps=100)
    return util, outcome([hog, shed, ok]), ok_status


def test_kv_pressure_shed():
    util, out, ok_status = both(_kv_pressure_shed)
    assert util >= 0.6
    assert out[1][1:] == ("shed", "kv_pressure")
    assert out[0][1] == out[2][1] == "finished" and ok_status == "queued"


def _deadline_shed(p):
    fe = p.s.ServingFrontend(p.engine(max_batch=2),
                             admission=p.s.AdmissionConfig())
    run_trace(fe, [[1, 2, 3]], max_new=4)
    warm = fe.scheduler.tpot_estimate() is not None
    doomed = fe.submit([1, 2, 3], max_new_tokens=10 ** 6, timeout_s=1e-4)
    relaxed = fe.submit([1, 2, 3], max_new_tokens=4, timeout_s=60.0)
    relaxed_status = relaxed.status.value
    fe.run_until_idle(max_steps=200)
    return (warm, outcome([doomed, relaxed]), relaxed_status,
            doomed._req.t_finish - doomed._req.t_submit < 0.005)


def test_deadline_unmeetable_shed_is_immediate():
    warm, out, relaxed_status, fast = both(_deadline_shed)
    assert warm and fast
    assert out[0][1:] == ("shed", "deadline_unmeetable")
    assert relaxed_status == "queued" and out[1][1] == "finished"


# ---------------------------------------------------------------------------
# EngineStalled (no watchdog)
# ---------------------------------------------------------------------------

def _wedged(p, how):
    eng = p.engine(max_batch=2, num_blocks=8)
    fe = p.s.ServingFrontend(eng, stall_after=16)
    # an external tenant leases every free block: the queued request can
    # never admit and nothing running will free blocks
    eng.manager.allocate(999, 7 * 4)
    h = fe.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(p.s.EngineStalled) as ei:
        if how == "run_until_idle":
            fe.run_until_idle(max_steps=10000)
        else:
            list(fe.stream(fe.submit([4, 5], max_new_tokens=2),
                           max_steps=10000))
    return ei.value.steps, "free_blocks" in str(ei.value), h.status.value


@pytest.mark.parametrize("how", ["run_until_idle", "stream"])
def test_wedged_engine_raises_typed_stall(how):
    steps, names_pool, status = both(_wedged, how)
    assert steps >= 16 and names_pool and status == "queued"


def _progress_resets(p):
    fe = p.s.ServingFrontend(p.engine(), stall_after=8)
    hs = run_trace(fe, prompts(6), max_new=12)
    return outcome(hs), fe.scheduler.zero_progress_steps


def test_progress_resets_the_counter():
    out, zero = both(_progress_resets)
    assert all(s == "finished" for _t, s, _r in out) and zero == 0


# ---------------------------------------------------------------------------
# Request fault isolation
# ---------------------------------------------------------------------------

def _clean(p, plist, max_new=6, spec=False):
    cfg = p.s.SpecDecodeConfig(p.s.NGramProposer(), num_draft_tokens=3) \
        if spec else None
    fe = p.s.ServingFrontend(p.engine(), spec=cfg)
    return [h.tokens for h in run_trace(fe, plist, max_new=max_new)]


def _prefill_chunk_fault(p):
    plist = prompts(3)
    clean = _clean(p, plist)
    fe = p.s.ServingFrontend(p.engine(), prefill_chunk_tokens=4)
    hs = [fe.submit(q, max_new_tokens=6) for q in plist]
    for _ in range(4):
        fe.step()
    victim = fe.submit(list(range(1, 17)), max_new_tokens=6)
    p.faults.inject("serve.decode", after_n=1, times=1,
                    exc=p.s.EngineStepError("decode",
                                            seq_ids=[victim.request_id]))
    fe.run_until_idle(max_steps=500)
    return clean, outcome(hs + [victim]), counters(p), leaks(fe)


def test_prefill_chunk_fault_fails_only_that_request():
    clean, out, c, lk = both(_prefill_chunk_fault)
    assert out[-1] == ([], "failed", "engine_fault:decode")
    assert [t for t, _s, _r in out[:-1]] == clean
    assert c["isolated_faults"] == c["isolated_faults.decode"] == 1
    assert lk == (0, 0)


def _targeted_or_nan(p, kind):
    plist = prompts(4)
    clean = _clean(p, plist)
    fe = p.s.ServingFrontend(p.engine())
    if kind == "nan":
        # flag: the scheduler poisons the FIRST live lane's logits row
        p.faults.inject("serve.decode", after_n=1, times=1, action="flag")
        hs = run_trace(fe, plist)
    else:
        hs = [fe.submit(q, max_new_tokens=6) for q in plist]
        p.faults.inject("serve.decode", after_n=1, times=1,
                        exc=p.s.EngineStepError(
                            "decode", seq_ids=[hs[2].request_id]))
        fe.run_until_idle(max_steps=500)
    return clean, outcome(hs), counters(p), leaks(fe)


@pytest.mark.parametrize("kind,reason", [("nan", "nan_logits"),
                                         ("typed", "engine_fault:decode")])
def test_isolated_decode_lane_survivors_bitwise(kind, reason):
    """A NaN lane (the `"flag"` fault) or a typed `EngineStepError`
    naming one lane fails that request alone; the survivors stream what a
    fault-free run streams."""
    clean, out, c, lk = both(_targeted_or_nan, kind)
    failed = [o for o in out if o[1] == "failed"]
    assert len(failed) == 1 and failed[0][2] == reason
    for (t, s, _r), ref in zip(out, clean):
        if s == "finished":
            assert t == ref
    assert c["isolated_faults.decode"] == 1 and lk == (0, 0)


def _transient(p, site, spec):
    plist = [([1, 2, 3] * 4)[:9], ([5, 6] * 5)[:8], prompts(1)[0]] \
        if spec else prompts(4)
    clean = _clean(p, plist, spec=spec)
    p.faults.inject(site, after_n=1 if spec else 2, times=1)
    cfg = p.s.SpecDecodeConfig(p.s.NGramProposer(), num_draft_tokens=3) \
        if spec else None
    fe = p.s.ServingFrontend(p.engine(), spec=cfg)
    hs = run_trace(fe, plist)
    return clean, outcome(hs), counters(p), leaks(fe)


@pytest.mark.parametrize("site,spec", [("serve.decode", False),
                                       ("serve.verify", True)])
def test_transient_dispatch_fault_replays_everyone(site, spec):
    """An untargeted injected dispatch fault is transient: nothing
    commits, everyone replays, the streams equal a fault-free run."""
    clean, out, c, lk = both(_transient, site, spec)
    assert [t for t, _s, _r in out] == clean
    assert all(s == "finished" for _t, s, _r in out)
    assert c["step_faults"] == 1 and c["isolated_faults"] == 0
    assert lk == (0, 0)


def _probe_attribution(p):
    plist = prompts(4)
    clean = _clean(p, plist)
    inner = p.engine()

    class VictimEngine:
        """Raises a PLAIN RuntimeError whenever the victim's lane is
        live."""

        def __init__(self):
            self.victim = None

        def __getattr__(self, name):
            return getattr(inner, name)

        def ragged_step(self, tokens, q_lens, kv_lens, tables):
            if self.victim is not None:
                try:
                    vrow = inner.manager.block_table_array(
                        [self.victim])[0]
                except KeyError:
                    vrow = None
                if vrow is not None and any(
                        int(r[0]) == int(vrow[0])
                        for r in np.asarray(tables)):
                    raise RuntimeError("victim lane poisons the step")
            return inner.ragged_step(tokens, q_lens, kv_lens, tables)

    eng = VictimEngine()
    fe = p.s.ServingFrontend(eng)
    hs = [fe.submit(q, max_new_tokens=6) for q in plist]
    fe.step()
    eng.victim = hs[1].request_id
    fe.run_until_idle(max_steps=500)
    return clean, outcome(hs), counters(p)


def test_probe_attribution_of_untyped_engine_fault():
    clean, out, c = both(_probe_attribution)
    assert out[1][1:] == ("failed", "engine_fault:decode")
    assert all(t == ref for i, ((t, _s, _r), ref) in
               enumerate(zip(out, clean)) if i != 1)
    assert c["isolated_faults.decode"] == 1


def _cache_or_sample_fault(p, site, after_n):
    plist = prompts(4)
    clean = _clean(p, plist)
    p.faults.inject(site, after_n=after_n, times=1)
    fe = p.s.ServingFrontend(p.engine())
    hs = run_trace(fe, plist)
    return clean, outcome(hs), counters(p), leaks(fe)


@pytest.mark.parametrize("site,after_n", [("serve.cache", 6),
                                          ("serve.sample", 5)])
def test_cache_and_sample_faults_terminal_and_leak_free(site, after_n):
    """A cache fault fails the request whose growth hit it; a sampler
    fault is transient. Everyone reaches a terminal status, finished
    streams equal the fault-free run, no block leaks."""
    clean, out, c, lk = both(_cache_or_sample_fault, site, after_n)
    assert all(s in ("finished", "failed") for _t, s, _r in out)
    for (t, s, _r), ref in zip(out, clean):
        if s == "finished":
            assert t == ref
    if site == "serve.cache":
        assert [r for _t, s, r in out if s == "failed"] == \
            ["engine_fault:cache"]
        assert c["isolated_faults.cache"] == 1
    assert lk == (0, 0)


def _spec_nan(p):
    plist = [([1, 2, 3] * 4)[:9], ([5, 6] * 5)[:8], prompts(1)[0]]
    clean = _clean(p, plist)
    p.faults.inject("serve.verify", after_n=1, times=1, action="flag")
    fe = p.s.ServingFrontend(p.engine(), spec=p.s.SpecDecodeConfig(
        p.s.NGramProposer(), num_draft_tokens=3))
    hs = run_trace(fe, plist)
    return clean, outcome(hs), counters(p), leaks(fe)


def test_spec_verify_nan_lane_isolated():
    clean, out, c, lk = both(_spec_nan)
    assert [r for _t, s, r in out if s == "failed"] == ["nan_logits"]
    for (t, s, _r), ref in zip(out, clean):
        if s == "finished":
            assert t == ref
    assert c["isolated_faults.verify"] == 1 and lk == (0, 0)


# ---------------------------------------------------------------------------
# Engine watchdog: stall detection + bounded restarts
# ---------------------------------------------------------------------------

def _escalation_restart(p):
    plist = prompts(4)
    clean = _clean(p, plist)
    # 3 consecutive unattributed faults (> step_retries=2) escalate to a
    # restart; the 4th fire lands after the rebuild
    p.faults.inject("serve.decode", times=4)
    fe = p.s.ServingFrontend(
        p.engine(), watchdog=p.s.WatchdogConfig(step_retries=2,
                                                max_restarts=2),
        engine_factory=p.engine)
    hs = run_trace(fe, plist)
    return (clean, outcome(hs), counters(p),
            fe.scheduler.engine_restarts_remaining, leaks(fe))


def test_transient_escalation_restart_recovers_with_parity():
    clean, out, c, remaining, lk = both(_escalation_restart)
    assert [t for t, _s, _r in out] == clean
    assert all(s == "finished" for _t, s, _r in out)
    assert c["engine_restarts"] == 1 and remaining == 1 and lk == (0, 0)


def _budget_exhaustion(p, factory):
    p.faults.inject("serve.decode", times=None)     # fires forever
    if factory == "respawn":
        eng = p.engine()
        fe = p.s.ServingFrontend(
            eng, watchdog=p.s.WatchdogConfig(step_retries=1, max_restarts=1),
            engine_factory=eng.respawn)
        hs = [fe.submit(q, max_new_tokens=6) for q in prompts(4)]
    else:
        fe = p.s.ServingFrontend(p.engine(),
                                 watchdog=p.s.WatchdogConfig(step_retries=1))
        hs = [fe.submit(q, max_new_tokens=4) for q in prompts(3)]
    fe.run_until_idle(max_steps=500)
    return outcome(hs), counters(p), leaks(fe)


@pytest.mark.parametrize("factory", ["respawn", None])
def test_restart_budget_exhaustion_fails_everything_typed(factory):
    """A fault that fires forever: through `MLPLMEngine.respawn` the one
    restart is spent and every request fails typed; with no factory the
    failure is typed at once (no hang)."""
    out, c, lk = both(_budget_exhaustion, factory)
    assert all(s == "failed" and r.startswith("engine_unrecoverable")
               for _t, s, r in out)
    assert c["engine_restarts"] == (1 if factory else 0)
    assert c["requests_failed"] == len(out)
    if factory:
        assert lk == (0, 0)


def _zero_progress_restart(p):
    eng = p.engine(max_batch=2, num_blocks=8)
    fe = p.s.ServingFrontend(
        eng, watchdog=p.s.WatchdogConfig(stall_steps=8, max_restarts=1),
        engine_factory=lambda: p.engine(max_batch=2, num_blocks=8),
        stall_after=64)
    eng.manager.allocate(999, 7 * 4)    # external tenant wedges the pool
    h = fe.submit([1, 2, 3], max_new_tokens=3)
    fe.run_until_idle(max_steps=500)
    return outcome([h]), counters(p)


def test_zero_progress_restart_recovers_wedged_pool():
    out, c = both(_zero_progress_restart)
    assert out[0][1] == "finished"
    assert c["engine_restarts"] == 1 and c["stall_detections"] >= 1


def _step_timeout(p, tick_s):
    ticks = [0.0]

    def clock():
        ticks[0] += tick_s
        return ticks[0]

    sch = p.s.Scheduler(
        p.engine(),
        watchdog=p.s.WatchdogConfig(stall_timeout_s=50.0, max_restarts=1),
        engine_factory=p.engine, clock=clock)
    r = p.Request([1, 2, 3], p.SamplingParams(max_new_tokens=3))
    sch.submit(r)
    for _ in range(50):
        if r.status.terminal:
            break
        sch.step()
    return (r.generated, r.status.value, r.finish_reason), counters(p)


@pytest.mark.parametrize("tick_s", [40.0, 80.0])
def test_step_timeout_stall_detection_injectable_clock(tick_s):
    """Every dispatch "takes" one tick of the injected clock: 40 s is
    under the 50 s budget (no stall); 80 s blows it on every dispatch, so
    stalls are detected and the restart budget drains to a terminal
    status."""
    out, c = both(_step_timeout, tick_s)
    if tick_s < 50:
        assert out[1] == "finished" and c["stall_detections"] == 0
    else:
        assert out[1] in ("finished", "failed", "timed_out")
        assert c["stall_detections"] >= 1 and c["engine_restarts"] <= 1


def _rebuild_failure(p, where):
    calls = {"n": 0}

    def flaky_factory():
        calls["n"] += 1
        raise RuntimeError("no capacity")

    def cache_factory():
        eng = p.engine()
        # the rebind (guard-block allocate) is the next cache op
        p.faults.inject("serve.cache", times=None)
        return eng

    p.faults.inject("serve.decode", times=None)
    fe = p.s.ServingFrontend(
        p.engine(), watchdog=p.s.WatchdogConfig(step_retries=1,
                                                max_restarts=3,
                                                rebuild_retries=1),
        engine_factory=flaky_factory if where == "factory"
        else cache_factory)
    hs = [fe.submit(q, max_new_tokens=4) for q in prompts(3)]
    fe.run_until_idle(max_steps=200)       # must not raise
    p.faults.clear()
    late = fe.submit([1, 2, 3], max_new_tokens=2)
    return outcome(hs + [late]), calls["n"]


@pytest.mark.parametrize("where", ["factory", "rebind"])
def test_rebuild_failure_fails_typed(where):
    """A factory that raises (after `rebuild_retries`), or a cache fault
    in the guard-block re-lease, fails every request typed, and the
    scheduler refuses to serve again."""
    out, calls = both(_rebuild_failure, where)
    assert all(s == "failed" and r.startswith("engine_rebuild_failed")
               for _t, s, r in out[:-1])
    assert out[-1][1] == "rejected"
    assert out[-1][2].startswith("engine_rebuild_failed")
    assert calls == (2 if where == "factory" else 0)


def _slow_and_raising(p):
    tick = {"d": 80.0, "t": 0.0}

    def clock():
        tick["t"] += tick["d"]
        return tick["t"]

    p.faults.inject("serve.decode", times=1)
    sch = p.s.Scheduler(
        p.engine(), watchdog=p.s.WatchdogConfig(
            stall_timeout_s=50.0, step_retries=0, max_restarts=2),
        engine_factory=p.engine, clock=clock)
    r = p.Request([1, 2, 3], p.SamplingParams(max_new_tokens=3))
    sch.submit(r)
    sch.step()
    first = (p.monitor.get("serving.engine_restarts"),
             sch.engine_restarts_remaining)
    tick["d"] = 0.0
    for _ in range(30):
        if r.status.terminal:
            break
        sch.step()
    return first, (r.generated, r.status.value), counters(p)


def test_slow_and_raising_dispatch_spends_one_restart():
    first, out, c = both(_slow_and_raising)
    assert first == (1, 1)
    assert out[1] == "finished" and c["engine_restarts"] == 1


def _factory_default_budget(p):
    p.faults.inject("serve.decode", times=8)   # > default step_retries
    fe = p.s.ServingFrontend(p.engine(), engine_factory=p.engine)
    hs = run_trace(fe, prompts(3), max_new=4, max_steps=500)
    return outcome(hs), counters(p), fe.scheduler.watchdog_active


def test_factory_without_watchdog_gets_default_budget():
    out, c, active = both(_factory_default_budget)
    assert active and all(s == "finished" for _t, s, _r in out)
    assert c["engine_restarts"] >= 1


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def _overload_fault_counters(p):
    p.faults.inject("serve.decode", after_n=1, times=1, action="flag")
    fe = p.s.ServingFrontend(p.engine(max_batch=1, num_blocks=32),
                             admission=p.s.AdmissionConfig(queue_high=1,
                                                           queue_low=0))
    h = fe.submit([1, 2, 3], max_new_tokens=6)
    shed = fe.submit([4, 5], max_new_tokens=2)
    fe.run_until_idle(max_steps=200)
    return (outcome([h, shed]), counters(p),
            p.s.ServingMetrics.shed_by_reason())


def test_overload_and_fault_counters():
    """The counters the JAX profiler's overload/faults block renders
    (the port has no profiler yet): shed total and reasons, isolated
    faults."""
    out, c, reasons = both(_overload_fault_counters)
    assert out[1][1] == "shed" and reasons == {"queue_depth": 1}
    assert c["shed_total"] == 1 and c["isolated_faults"] == 1


def _queued_cost(p):
    fe = p.s.ServingFrontend(p.engine(max_batch=1, num_blocks=32))
    for _ in range(3):
        fe.submit([1, 2, 3], max_new_tokens=7)
    before = (_gauge(p, fe, "serving.queued_cost"),
              _gauge(p, fe, "serving.queued_cost_peak"))
    fe.run_until_idle(max_steps=300)
    return before, _gauge(p, fe, "serving.queued_cost")


def test_queued_cost_gauge_tracks_backlog():
    before, after = both(_queued_cost)
    assert before == (21, 21) and after == 0
