"""The port's elastic membership (`paddle_tpu_torch.distributed.elastic`)
against the JAX package's: the unit scenarios of `tests/test_elastic.py`
(store and manager; its launcher integration test drives the JAX
package's launch CLI, which the port does not have) on the port with
their own assertions, and the same operations on both packages' stores
and managers, each on its own file, under one fake clock: every return
value, every `alive()` snapshot and the `elastic.*` counters equal,
operation for operation. Nothing sleeps: time moves only on the fake
clock."""
import os
import threading

import numpy as np
import pytest

from paddle_tpu.distributed.elastic import ElasticManager as JaxManager
from paddle_tpu.distributed.elastic import MembershipStore as JaxStore
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu_torch.distributed.elastic import (ElasticManager,
                                                  MembershipStore)
from paddle_tpu_torch.framework import monitor


@pytest.fixture(autouse=True)
def _clean():
    for m in (monitor, jmonitor):
        m.reset_prefix("elastic.")
    yield


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _mgr(tmp_path, clock, name="m.json", store_cls=MembershipStore,
         mgr_cls=ElasticManager, ttl=30, **kw):
    st = store_cls(str(tmp_path / name), ttl=ttl, clock=clock)
    kw.setdefault("min_nodes", 1)
    kw.setdefault("max_nodes", 8)
    kw.setdefault("stabilize_s", 1.0)
    return st, mgr_cls(st, clock=clock, sleep=clock.sleep, **kw)


class TestMembershipStore:
    def test_register_heartbeat_expire(self, tmp_path):
        clock = FakeClock(100.0)
        st = MembershipStore(str(tmp_path / "m.json"), ttl=0.5, clock=clock)
        st.register("a", "h:1")
        st.register("b", "h:2")
        assert sorted(st.alive()) == ["a", "b"]
        clock.t += 0.3
        st.heartbeat("a")
        clock.t += 0.35            # b's lease lapsed, a's renewed
        assert sorted(st.alive()) == ["a"]
        st.deregister("a")
        assert st.alive() == {}

    def test_concurrent_registration(self, tmp_path):
        st = MembershipStore(str(tmp_path / "m.json"), ttl=30)

        def reg(i):
            MembershipStore(str(tmp_path / "m.json"), ttl=30).register(
                f"pod{i}")

        threads = [threading.Thread(target=reg, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(st.alive()) == 16   # no lost update under the lock


class TestElasticManager:
    def test_rank_regeneration_and_bounds(self, tmp_path):
        st, mgr = _mgr(tmp_path, FakeClock(), max_nodes=3)
        for pid in ("h:slot2", "h:slot0", "h:slot1", "h:slot3"):
            mgr.register(pid)
        assert mgr.ranks() == ["h:slot0", "h:slot1", "h:slot2"]
        mgr.report_dead("h:slot1")
        assert mgr.ranks() == ["h:slot0", "h:slot2", "h:slot3"]
        changed, now = mgr.scale_changed(["h:slot0", "h:slot1", "h:slot2"])
        assert changed and len(now) == 3

    def test_wait_for_world_blocks_until_min(self, tmp_path):
        clock = FakeClock()
        st, mgr = _mgr(tmp_path, clock, min_nodes=2, max_nodes=4,
                       stabilize_s=0.05)
        assert mgr.wait_for_world(deadline_s=0.5) is None  # empty store
        mgr.register("a")
        t0, sleep = clock.t, clock.sleep

        def joining_sleep(s):        # "b" joins 0.3 s into the wait
            sleep(s)
            if clock.t - t0 >= 0.3 and "b" not in st.alive():
                mgr.register("b")

        mgr._sleep = joining_sleep
        assert mgr.wait_for_world(deadline_s=5.0) == ["a", "b"]
        assert 0.3 <= clock.t - t0 < 5.0

    def test_invalid_range(self, tmp_path):
        st = MembershipStore(str(tmp_path / "m.json"))
        with pytest.raises(ValueError):
            ElasticManager(st, min_nodes=3, max_nodes=2)


class TestIncarnationEpochs:
    def test_register_bumps_incarnation(self, tmp_path):
        st = MembershipStore(str(tmp_path / "m.json"), ttl=30)
        inc1 = st.register("a")
        inc2 = st.register("a")
        assert inc2 == inc1 + 1
        assert st.alive()["a"]["incarnation"] == inc2

    def test_stale_heartbeat_rejected(self, tmp_path):
        st = MembershipStore(str(tmp_path / "m.json"), ttl=30)
        inc1 = st.register("a")
        inc2 = st.register("a")
        assert st.heartbeat("a", incarnation=inc1) is False
        assert st.heartbeat("a", incarnation=inc2) is True
        assert st.heartbeat_many(["a"], incarnations={"a": inc1}) == ["a"]
        assert monitor.get("elastic.stale_heartbeats") >= 2

    def test_stale_heartbeat_cannot_revive_reaped_pod(self, tmp_path):
        clock = FakeClock(50.0)
        st = MembershipStore(str(tmp_path / "m.json"), ttl=30, clock=clock)
        inc = st.register("a")
        assert st.reap_stale(0.0, now=clock.t + 100) == ["a"]
        assert st.heartbeat("a", incarnation=inc) is False
        assert "a" not in st.alive()
        st.heartbeat("a")
        assert "a" not in st.alive()

    def test_fenced_deregister_spares_successor(self, tmp_path):
        st = MembershipStore(str(tmp_path / "m.json"), ttl=30)
        inc1 = st.register("a")
        inc2 = st.register("a")
        assert st.deregister("a", incarnation=inc1) is False
        assert st.alive()["a"]["incarnation"] == inc2
        assert st.deregister("a", incarnation=inc2) is True
        assert "a" not in st.alive()
        st.register("b")
        assert st.deregister("b") is True

    def test_heartbeat_payload_refresh(self, tmp_path):
        st = MembershipStore(str(tmp_path / "m.json"), ttl=30)
        inc = st.register("a", payload={"queue_depth": 0})
        st.heartbeat("a", incarnation=inc, payload={"queue_depth": 7})
        assert st.alive()["a"]["payload"] == {"queue_depth": 7}

    def test_zero_sleep_wait_for_world(self, tmp_path):
        clock = FakeClock()
        st, mgr = _mgr(tmp_path, clock, min_nodes=2, max_nodes=4)
        assert mgr.wait_for_world(deadline_s=30.0) is None
        assert clock.t >= 30.0 and clock.sleeps.count(0.2) > 100
        mgr.register("a")
        mgr.register("b")
        assert mgr.wait_for_world(deadline_s=30.0) == ["a", "b"]
        assert 1.0 in clock.sleeps


class TestQuorumAndReapPayloads:
    def test_wait_for_quorum_zero_sleep(self, tmp_path):
        clock = FakeClock()
        st, mgr = _mgr(tmp_path, clock)
        st.register("a")
        assert mgr.wait_for_quorum(3, deadline_s=30.0) is None
        assert clock.t >= 30.0 and clock.sleeps.count(0.2) > 100
        for pod in "abcd":
            st.register(pod)
        assert mgr.wait_for_quorum(3, deadline_s=30.0) \
            == ["a", "b", "c", "d"]
        assert 1.0 in clock.sleeps

    def test_wait_for_quorum_even_with_zero_deadline(self, tmp_path):
        st, mgr = _mgr(tmp_path, FakeClock(), stabilize_s=0.0)
        st.register("a")
        assert mgr.wait_for_quorum(1, deadline_s=0.0) == ["a"]
        with pytest.raises(ValueError):
            mgr.wait_for_quorum(0)

    def test_reap_stale_returns_final_payloads(self, tmp_path):
        clock = FakeClock()
        st, mgr = _mgr(tmp_path, clock)
        st.register("a")
        st.register("b", payload={"step": 1, "loss": 0.5})
        st.heartbeat("b", payload={"step": 7, "loss": 0.25})
        clock.t += 100.0
        reaped, payloads = mgr.reap_stale(timeout_s=50,
                                          return_payloads=True)
        assert reaped == ["a", "b"]
        assert payloads == {"a": None, "b": {"step": 7, "loss": 0.25}}
        assert mgr.reap_stale(timeout_s=50) == []
        assert monitor.get("elastic.reaped") == 2

    def test_noop_sweep_does_not_rewrite_the_store(self, tmp_path):
        st = MembershipStore(str(tmp_path / "m.json"), ttl=1000)
        st.register("a")
        ino = os.stat(tmp_path / "m.json").st_ino
        assert st.reap_stale(1000) == []
        assert sorted(st.alive()) == ["a"]
        assert os.stat(tmp_path / "m.json").st_ino == ino
        st.heartbeat("a")
        assert os.stat(tmp_path / "m.json").st_ino != ino

    def test_store_injectable_clock_drives_expiry(self, tmp_path):
        clock = FakeClock()
        st = MembershipStore(str(tmp_path / "m.json"), ttl=10, clock=clock)
        st.register("a")
        clock.t = 5.0
        st.heartbeat("a")
        clock.t = 14.0
        assert sorted(st.alive()) == ["a"]
        clock.t = 26.0
        assert st.alive() == {}

    def test_clear_and_lock_file(self, tmp_path):
        st = MembershipStore(str(tmp_path / "sub" / "m.json"), ttl=30)
        st.register("a")
        assert os.path.exists(str(tmp_path / "sub" / "m.json.lock"))
        st.clear()
        assert st.alive() == {}


# ---------------------------------------------------------------------------
# operation for operation against the JAX package
# ---------------------------------------------------------------------------

def _ops(seed, n=120):
    """A random membership history over 5 pod ids: registrations (with and
    without payloads), guarded and unguarded heartbeats, batch heartbeats,
    fenced and operator deregistrations, reap sweeps, expiry reads and
    clock advances."""
    rng = np.random.default_rng(seed)
    pods = [f"pod{i}" for i in range(5)]
    ops = []
    for _ in range(n):
        kind = int(rng.integers(0, 8))
        pid = pods[int(rng.integers(0, 5))]
        inc = int(rng.integers(0, 4))
        if kind == 0:
            ops.append(("register", pid, {"q": int(rng.integers(0, 9))}
                        if rng.random() < 0.5 else None))
        elif kind == 1:
            ops.append(("heartbeat", pid, inc or None))
        elif kind == 2:
            ids = sorted({pods[int(i)] for i in rng.integers(0, 5, 3)})
            ops.append(("heartbeat_many", ids,
                        {p: int(rng.integers(1, 4)) for p in ids
                         if rng.random() < 0.5}))
        elif kind == 3:
            ops.append(("deregister", pid, inc or None))
        elif kind == 4:
            ops.append(("reap", float(rng.integers(1, 20))))
        elif kind == 5:
            ops.append(("alive",))
        elif kind == 6:
            ops.append(("ranks",))
        else:
            ops.append(("advance", float(rng.integers(1, 15))))
    return ops


def _apply(st, mgr, clock, ops, mon):
    out = []
    for op in ops:
        kind = op[0]
        if kind == "register":
            out.append(mgr.register(op[1], payload=op[2]))
        elif kind == "heartbeat":
            out.append(mgr.heartbeat(op[1], incarnation=op[2],
                                     payload={"t": clock.t}))
        elif kind == "heartbeat_many":
            out.append(mgr.heartbeat_many(op[1], incarnations=op[2]))
        elif kind == "deregister":
            out.append(st.deregister(op[1], incarnation=op[2]))
        elif kind == "reap":
            out.append(mgr.reap_stale(timeout_s=op[1], return_payloads=True))
        elif kind == "alive":
            out.append(st.alive())
        elif kind == "ranks":
            out.append(mgr.ranks())
        else:
            clock.t += op[1]
            out.append(clock.t)
    return out, mon.snapshot("elastic.")


@pytest.mark.parametrize("seed", range(4))
def test_store_and_manager_match_jax(tmp_path, seed):
    ops = _ops(seed)
    results = []
    for name, store_cls, mgr_cls, mon in (
            ("port", MembershipStore, ElasticManager, monitor),
            ("jax", JaxStore, JaxManager, jmonitor)):
        mon.reset_prefix("elastic.")
        clock = FakeClock(1000.0)
        st, mgr = _mgr(tmp_path, clock, name=f"{name}.json",
                       store_cls=store_cls, mgr_cls=mgr_cls, ttl=12,
                       max_nodes=3)
        results.append(_apply(st, mgr, clock, ops, mon))
    port, jax = results
    assert port[0] == jax[0]
    assert {k: v for k, v in port[1].items() if v} \
        == {k: v for k, v in jax[1].items() if v}


def test_quorum_waits_match_jax(tmp_path):
    outs = []
    for store_cls, mgr_cls in ((MembershipStore, ElasticManager),
                               (JaxStore, JaxManager)):
        clock = FakeClock()
        st, mgr = _mgr(tmp_path, clock, name=f"{mgr_cls.__module__}.json",
                       store_cls=store_cls, mgr_cls=mgr_cls, min_nodes=2)
        st.register("b")
        first = mgr.wait_for_world(deadline_s=3.0)
        st.register("a")
        outs.append((first, mgr.wait_for_world(deadline_s=3.0),
                     mgr.wait_for_quorum(1, deadline_s=1.0), clock.t,
                     clock.sleeps))
    assert outs[0] == outs[1]
