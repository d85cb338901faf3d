"""Fleet routing on the port (`paddle_tpu_torch.serving.fleet`): every
scenario of the JAX suite `tests/test_serving_fleet.py` (but the
profiler's fleet line, whose profiler is not ported) runs on the port
(`device="cpu"`) with the JAX suite's own assertions, on the same tiny
MLP engine; placement, kill-and-fold and drain-and-ship also run on the
JAX router, and the outcomes are compared: token streams, statuses,
reasons, replica ids, relocation counts, each request's timeline event
names in order, the `fleet.*` counters (shipped KV bytes included) and
the replicas' fates. Membership time runs on one fake clock (the store's
and the router's): nothing sleeps. Last, the kernel launch counters stay
exact under threads (the `parallel=True` fleet steps replicas from a
thread pool)."""
import os
import sys
import threading

import pytest

import torch_fleet_common as C
from paddle_tpu_torch.distributed.elastic import MembershipStore
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.ops.kernels import _support
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (AdmissionConfig, FleetRouter,
                                      RequestStatus, ServingFrontend,
                                      WatchdogConfig)
from paddle_tpu_torch.serving import fleet as fleet_mod

POOL = C.JaxEnginePool()
JAX, PORT = C.packages(POOL)
make_engine = PORT.make_engine
prompts = C.prompts


@pytest.fixture(autouse=True)
def _clean():
    for p in (JAX, PORT):
        C.fresh(p)
    yield
    for p in (JAX, PORT):
        p.faults.clear()
        p.obs.disable()


@pytest.fixture
def router():
    r = FleetRouter(make_engine, num_replicas=3)
    yield r
    r.close()


def reference_tokens(ps, max_new=6):
    return C.reference_tokens(PORT, ps, max_new)


def _fates(r):
    return [(rep.replica_id, rep.alive, rep.death_reason, rep.role)
            for rep in r.replicas]


# ---------------------------------------------------------------------------
# held to the JAX router
# ---------------------------------------------------------------------------

class TestAgainstJax:
    def test_placement(self):
        def scenario(p):
            ps = prompts(10)
            ref = C.reference_tokens(p, ps)
            with p.s.FleetRouter(p.make_engine, num_replicas=3) as r:
                hs = [r.submit(x, max_new_tokens=6) for x in ps]
                r.run_until_idle()
                assert [h.tokens for h in hs] == ref
                assert len({h.replica_id for h in hs}) == 3
                return (C.handle_outcome(hs),
                        C.fleet_counters(p), _fates(r),
                        r.fleet_summary()["aggregate"]
                        ["fleet.tokens_generated"])

        C.both(POOL, scenario)

    def test_kill_and_fold(self):
        def scenario(p):
            ps = prompts(9, seed=5)
            ref = C.reference_tokens(p, ps)
            with p.s.FleetRouter(p.make_engine, num_replicas=3) as r:
                hs = [r.submit(x, max_new_tokens=6) for x in ps]
                for _ in range(3):
                    r.step()
                killed = r.chaos_kill_replica()
                r.run_until_idle()
                assert [h.tokens for h in hs] == ref
                moved = [h for h in hs if h.num_relocations]
                assert moved and all(h.replica_id != killed for h in moved)
                assert all(rep.scheduler.kv_leaked_blocks() == 0
                           for rep in r.live_replicas)
                return (killed, C.handle_outcome(hs),
                        C.fleet_counters(p), _fates(r))

        out = C.both(POOL, scenario)
        names = [o[-1] for o in out[1] if o[4]]
        assert all("relocated" in n for n in names)
        assert out[2]["fleet.relocations"] == len(names)
        assert out[2]["fleet.relocated_tokens"] > 0

    def test_drain_and_ship(self):
        def scenario(p):
            ps = prompts(8)
            ref = C.reference_tokens(p, ps)
            with p.s.FleetRouter(p.make_engine, num_replicas=3) as r:
                hs = [r.submit(x, max_new_tokens=6) for x in ps]
                for _ in range(2):
                    r.step()
                victim = hs[0].replica_id
                r.drain_replica(victim)
                h2 = r.submit(prompts(1, seed=9)[0], max_new_tokens=2)
                assert h2.replica_id != victim
                r.run_until_idle()
                assert [h.tokens for h in hs] == ref
                assert victim not in r.store.alive()
                assert all(rep.scheduler.kv_leaked_blocks() == 0
                           for rep in r.replicas)
                return (victim, C.handle_outcome(hs + [h2]),
                        C.fleet_counters(p), _fates(r),
                        p.monitor.get("serving.prefills"))

        out = C.both(POOL, scenario)
        counters = out[2]
        assert counters["fleet.relocations_shipped"] >= 1
        assert counters["fleet.shipped_kv_bytes"] > 0
        assert counters["fleet.drained"] == 1

    def test_drain_ships_one_session_without_reprefill(self):
        def scenario(p):
            ps = prompts(1, seed=21, lo=6, hi=10)
            ref = C.reference_tokens(p, ps, max_new=12)
            with p.s.FleetRouter(p.make_engine, num_replicas=2) as r:
                h = r.submit(ps[0], max_new_tokens=12)
                while len(h._req.generated) < 2:
                    r.step()
                prefills0 = p.monitor.get("serving.prefills")
                r.drain_replica(h.replica_id)
                r.run_until_idle()
                assert h.tokens == ref[0]
                assert p.monitor.get("serving.prefills") == prefills0
                return (C.handle_outcome([h]),
                        C.fleet_counters(p))

        out = C.both(POOL, scenario)
        assert out[1]["fleet.relocations_shipped"] == 1
        # one block of 4 slots x 16 f32 per committed block: 9-10 tokens
        assert out[1]["fleet.shipped_kv_bytes"] % (4 * 16 * 4) == 0


# ---------------------------------------------------------------------------
# every scenario of tests/test_serving_fleet.py, on the port
# ---------------------------------------------------------------------------

class TestPlacement:
    def test_least_loaded_prefers_empty_replica(self, router):
        a = router.submit(prompts(1)[0], max_new_tokens=30)
        router.step()
        b = router.submit(prompts(1, seed=1)[0], max_new_tokens=2)
        assert b.replica_id != a.replica_id
        router.run_until_idle()

    def test_session_affinity_sticks_and_counts(self, router):
        p = prompts(2, seed=3)
        a = router.submit(p[0], max_new_tokens=3, session_id="alice")
        router.run_until_idle()
        b = router.submit(p[1], max_new_tokens=3, session_id="alice")
        router.run_until_idle()
        assert a.replica_id == b.replica_id
        assert monitor.get("fleet.session_hits") == 1
        router.fail_replica(a.replica_id)
        c = router.submit(p[0], max_new_tokens=3, session_id="alice")
        router.run_until_idle()
        assert c.replica_id != a.replica_id
        assert monitor.get("fleet.session_misses") == 1

    def test_handle_surface(self, router):
        h = router.submit(prompts(1)[0], max_new_tokens=3)
        assert h.replica_id in {r.replica_id for r in router.replicas}
        assert h.num_relocations == 0
        assert "FleetHandle" in repr(h)
        router.run_until_idle()
        assert h.finished and h.tokens

    def test_shed_retries_on_second_replica(self):
        r = FleetRouter(make_engine, num_replicas=2,
                        frontend_kwargs=dict(
                            admission=AdmissionConfig(queue_high=1)))
        try:
            hs = [r.submit(p, max_new_tokens=2) for p in prompts(6)]
            shed = [h for h in hs if h.status is RequestStatus.SHED]
            placed = [h for h in hs if not h.status.terminal]
            assert len({h.replica_id for h in placed}) == 2
            r.run_until_idle()
            assert all(h.finished for h in hs)
            for h in shed:
                assert h.status is RequestStatus.SHED
        finally:
            r.close()

    def test_submit_fault_fails_over(self, router):
        faults.inject("fleet.submit", after_n=0, times=1)
        h = router.submit(prompts(1)[0], max_new_tokens=3)
        assert not h.status.terminal
        assert monitor.get("fleet.submit_faults") == 1
        router.run_until_idle()
        assert h.status is RequestStatus.FINISHED


class TestRelocation:
    def test_relocated_event_on_timeline(self, router):
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch.observability import timeline

        obs.enable()
        hs = [router.submit(p, max_new_tokens=6) for p in prompts(6)]
        for _ in range(2):
            router.step()
        router.fail_replica(hs[0].replica_id, reason="test")
        router.run_until_idle()
        moved = [h for h in hs if h.num_relocations][0]
        names = [e["name"] for e in moved.timeline()]
        assert "relocated" in names
        ev = [e for e in moved.timeline() if e["name"] == "relocated"][0]
        assert ev["meta"]["reason"].startswith("replica_dead")
        assert ev["meta"]["tokens_carried"] == len(moved._prefix)
        chrome = timeline.chrome_events()
        assert any(e.get("name") == "relocated" for e in chrome)
        assert any(e.get("name", "").startswith("fleet.replica_dead")
                   for e in chrome)

    def test_relocation_budget_exhausted_fails_typed(self):
        r = FleetRouter(make_engine, num_replicas=2, relocation_budget=0)
        try:
            hs = [r.submit(p, max_new_tokens=8) for p in prompts(6)]
            for _ in range(2):
                r.step()
            r.fail_replica(hs[0].replica_id)
            r.run_until_idle()
            assert all(h.finished for h in hs)
            failed = [h for h in hs if h.status is RequestStatus.FAILED]
            assert failed and all(
                h.finish_reason == "relocation_budget_exhausted"
                for h in failed)
            assert any(h.status is RequestStatus.FINISHED for h in hs)
            assert monitor.get(
                "fleet.requests_failed.relocation_budget_exhausted") \
                == len(failed)
        finally:
            r.close()

    def test_fully_committed_request_finishes_on_relocation(self, router):
        h = router.submit(prompts(1)[0], max_new_tokens=1)
        hs = [router.submit(p, max_new_tokens=12) for p in prompts(5)]
        while not h._req.generated:
            router.step()
        router.fail_replica(h.replica_id)
        assert h.status is RequestStatus.FINISHED
        assert h.finish_reason == "max_new_tokens"
        assert len(h.tokens) == 1
        router.run_until_idle()
        assert all(x.finished for x in hs)

    def test_last_replica_death_fails_typed(self):
        r = FleetRouter(make_engine, num_replicas=1)
        try:
            hs = [r.submit(p, max_new_tokens=8) for p in prompts(4)]
            r.step()
            r.fail_replica(hs[0].replica_id)
            assert all(h.status is RequestStatus.FAILED for h in hs)
            assert all(h.finish_reason == "no_replica_available"
                       for h in hs)
            r.add_replica()
            h2 = r.submit(prompts(1)[0], max_new_tokens=3)
            r.run_until_idle()
            assert h2.status is RequestStatus.FINISHED
        finally:
            r.close()

    def test_unrecoverable_replica_escalates_to_relocation(self):
        class BadEngine:
            def __init__(self):
                self._inner = make_engine()

            def __getattr__(self, name):
                return getattr(self._inner, name)

            def ragged_step(self, *a):
                raise faults.InjectedIOError("poisoned engine")

        r = FleetRouter(
            BadEngine, num_replicas=1,
            frontend_kwargs=dict(watchdog=WatchdogConfig(
                step_retries=1, max_restarts=1, stall_steps=8)))
        try:
            r.add_replica(make_engine)
            hs = [r.submit(p, max_new_tokens=4) for p in prompts(6)]
            r.run_until_idle(max_steps=3000)
            assert all(h.status is RequestStatus.FINISHED for h in hs)
            assert monitor.get("fleet.replica_deaths") >= 1
            sick = r.replicas[0]
            assert not sick.alive
            assert sick.death_reason == "engine_unrecoverable"
        finally:
            r.close()

    def test_step_that_raises_kills_only_its_replica(self):
        ps = prompts(6, seed=2)
        ref = reference_tokens(ps)
        r = FleetRouter(make_engine, num_replicas=2)
        try:
            hs = [r.submit(p, max_new_tokens=6) for p in ps]
            r.step()
            sick = r.replicas[0]

            def boom():
                raise RuntimeError("replica crashed")

            sick.frontend.step = boom
            r.run_until_idle()
            assert not sick.alive and sick.death_reason == "step_raised"
            assert [h.tokens for h in hs] == ref
        finally:
            r.close()


class TestDrainScaleOut:
    def test_drain_finish_in_place(self, router):
        hs = [router.submit(p, max_new_tokens=4) for p in prompts(6)]
        router.step()
        victim = hs[0].replica_id
        router.drain_replica(victim, relocate=False)
        router.run_until_idle()
        assert all(h.status is RequestStatus.FINISHED for h in hs)
        assert all(h.num_relocations == 0 for h in hs)
        assert not router._rep(victim).alive

    def test_drain_sole_replica_finishes_in_place(self):
        r = FleetRouter(make_engine, num_replicas=1)
        try:
            hs = [r.submit(p, max_new_tokens=5) for p in prompts(4)]
            r.step()
            r.drain_replica(hs[0].replica_id)
            r.run_until_idle()
            assert all(h.status is RequestStatus.FINISHED for h in hs)
            assert not r.replicas[0].alive
            assert r.replicas[0].death_reason == "drained"
        finally:
            r.close()

    def test_default_timeout_applies_to_fleet_submits(self, router):
        router.frontend_kwargs["default_timeout_s"] = 30.0
        h = router.submit(prompts(1)[0], max_new_tokens=2)
        assert h._req.deadline is not None
        h2 = router.submit(prompts(1)[0], max_new_tokens=2, timeout_s=5.0)
        assert h2._req.deadline < h._req.deadline
        router.run_until_idle()

    def test_session_map_bounded(self, router, monkeypatch):
        monkeypatch.setattr(fleet_mod, "_SESSION_CAP", 4)
        for i in range(10):
            router.submit(prompts(1)[0], max_new_tokens=1,
                          session_id=f"s{i}")
        assert len(router._sessions) <= 4
        assert "s9" in router._sessions
        router.run_until_idle()

    def test_add_replica_joins_membership_and_serves(self, router):
        rid = router.add_replica()
        assert rid in router.store.alive()
        assert monitor.get("fleet.replicas_added") == 1
        busy = [router.submit(p, max_new_tokens=20) for p in prompts(3)]
        router.step()
        h = router.submit(prompts(1, seed=4)[0], max_new_tokens=2)
        assert h.replica_id == rid
        router.run_until_idle()
        assert h.status is RequestStatus.FINISHED
        assert all(b.finished for b in busy)

    def test_config_errors(self):
        with pytest.raises(ValueError):
            FleetRouter(make_engine, num_replicas=0)
        with FleetRouter(make_engine, num_replicas=1) as r:
            with pytest.raises(ValueError):
                r.add_replica(role="typo")


class TestMembership:
    def test_heartbeats_carry_load_payload(self):
        r = FleetRouter(make_engine, num_replicas=2, heartbeat_every=1)
        try:
            hs = [r.submit(p, max_new_tokens=4) for p in prompts(6)]
            r.step()
            pods = r.store.alive()
            assert len(pods) == 2
            for entry in pods.values():
                assert entry["incarnation"] >= 1
                pl = entry["payload"]
                assert {"queue_depth", "running", "queued_cost",
                        "kv_utilization", "tokens_generated",
                        "prefix_hit_rate", "resident_adapters"} <= set(pl)
                assert pl["prefix_hit_rate"] == 0.0
            r.run_until_idle()
            assert all(h.finished for h in hs)
        finally:
            r.close()

    def test_heartbeat_payload_reports_replica_prefix_hit_rate(self):
        import numpy as np

        r = FleetRouter(make_engine, num_replicas=2, heartbeat_every=1,
                        frontend_kwargs={"prefix_cache": True})
        try:
            prompt = np.random.default_rng(21).integers(
                1, C.VOCAB, 12).tolist()
            h1 = r.submit(prompt, max_new_tokens=3, session_id="s1")
            r.run_until_idle()
            home = h1.replica_id
            h2 = r.submit(prompt, max_new_tokens=3, session_id="s1")
            assert h2.replica_id == home
            r.run_until_idle()
            assert h2.status is RequestStatus.FINISHED
            r.step()
            rates = {rid: e["payload"]["prefix_hit_rate"]
                     for rid, e in r.store.alive().items()}
            assert rates[home] > 0.0
            assert all(v == 0.0 for k, v in rates.items() if k != home)
            assert any(s["fleet.prefix_hit_rate_pct"] > 0
                       for s in r.replica_snapshots())
        finally:
            r.close()

    def _clocked(self, tmp_path, **kw):
        """A router whose store and membership sweeps run on one fake
        clock (`now[0]`, seconds)."""
        now = [1000.0]
        store = MembershipStore(str(tmp_path / "m.json"), ttl=10.0,
                                clock=lambda: now[0])
        r = FleetRouter(make_engine, store=store,
                        wall_clock=lambda: now[0], **kw)
        return r, now

    def test_reaped_replica_relocates_work(self, tmp_path):
        r, _now = self._clocked(tmp_path, num_replicas=2, sweep_every=1)
        try:
            hs = [r.submit(p, max_new_tokens=6) for p in prompts(6)]
            r.step()
            r.store.deregister(r.replicas[0].replica_id)
            lost = r.sweep_membership()
            assert lost == [r.replicas[0].replica_id]
            assert not r.replicas[0].alive
            assert r.replicas[0].death_reason == "membership_lost"
            r.run_until_idle()
            assert all(h.status is RequestStatus.FINISHED for h in hs)
        finally:
            r.close()

    def test_silent_replica_is_reaped_by_ttl(self, tmp_path):
        ps = prompts(6, seed=4)
        ref = reference_tokens(ps)
        r, now = self._clocked(tmp_path, num_replicas=2, heartbeat_every=1,
                               sweep_every=1)
        try:
            hs = [r.submit(p, max_new_tokens=6) for p in ps]
            r.step()
            # replica-0's heartbeats stop reaching the store: its lease
            # ages past the TTL on the fake clock alone
            silent = r.replicas[0]
            beat = r.manager.heartbeat_many
            r.manager.heartbeat_many = lambda ids, incarnations=None, \
                payloads=None: beat(
                    [i for i in ids if i != silent.replica_id],
                    incarnations, payloads)
            now[0] += 11.0
            r.step()
            assert not silent.alive
            assert silent.death_reason == "membership_reaped"
            assert monitor.get("elastic.reaped") == 1
            r.run_until_idle()
            assert [h.tokens for h in hs] == ref
        finally:
            r.close()

    def test_superseded_lease_fences_replica(self, tmp_path):
        r, _now = self._clocked(tmp_path, num_replicas=2, heartbeat_every=1)
        try:
            hs = [r.submit(p, max_new_tokens=6) for p in prompts(6)]
            r.step()
            rid = r.replicas[0].replica_id
            r.store.register(rid)
            r.step()
            assert not r.replicas[0].alive
            assert r.replicas[0].death_reason == "lease_lost"
            assert monitor.get("elastic.stale_heartbeats") >= 1
            # the fenced replica's removal spared its successor's lease
            assert rid in r.store.alive()
            r.run_until_idle()
            assert all(h.finished for h in hs)
        finally:
            r.close()


class TestOneSurface:
    def test_fleet_summary_aggregates_replicas(self, router):
        hs = [router.submit(p, max_new_tokens=4) for p in prompts(8)]
        router.run_until_idle()
        fs = router.fleet_summary()
        assert fs["replicas"] == 3 and fs["alive"] == 3
        total = sum(len(h.tokens) for h in hs)
        assert fs["aggregate"]["fleet.tokens_generated"] == total
        assert fs["straggler_replica"] in {r.replica_id
                                           for r in router.replicas}
        assert fs["counters"]["fleet.submitted"] == 8
        assert monitor.get("mesh.hosts") == 3

    def test_dead_replica_reports_history_not_load(self, router):
        hs = [router.submit(p, max_new_tokens=6) for p in prompts(6)]
        for _ in range(2):
            router.step()
        router.fail_replica(hs[0].replica_id)
        router.run_until_idle()
        snaps = router.replica_snapshots()
        dead_idx = next(i for i, rep in enumerate(router.replicas)
                        if not rep.alive)
        dead = snaps[dead_idx]
        assert dead["fleet.alive"] == 0
        assert dead["fleet.running"] == 0 and dead["fleet.queue_depth"] == 0
        assert dead["fleet.tokens_generated"] >= 0
        assert router.fleet_summary()["dead"] == {
            router.replicas[dead_idx].replica_id: "killed"}

    def test_parallel_step_mode_parity(self):
        ps = prompts(8, seed=11)
        ref = reference_tokens(ps)
        r = FleetRouter(make_engine, num_replicas=2, parallel=True)
        try:
            hs = [r.submit(p, max_new_tokens=6) for p in ps]
            r.run_until_idle()
            assert [h.tokens for h in hs] == ref
            assert all(rep.scheduler.prefix_stream_hook is None
                       for rep in r.replicas)
        finally:
            r.close()


def test_launch_counter_is_exact_under_threads():
    """More threads than cores add to one counter with the interpreter
    switching threads as often as it can: a lost increment would show in
    the total."""
    counter = _support.launch_counter("test.threaded_launches")
    counter.count = 0
    threads, per = 4 * (os.cpu_count() or 4), 5000

    def work():
        for _ in range(per):
            counter.add()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert counter.count == threads * per
    _support.reset_launch_counts()
    assert counter.count == 0


def test_frontend_standalone_handle_has_no_replica():
    fe = ServingFrontend(make_engine())
    h = fe.submit(prompts(1)[0], max_new_tokens=2)
    fe.run_until_idle()
    assert h.replica_id is None and h.num_relocations == 0
    assert h.timeline() == []
