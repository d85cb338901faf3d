"""Elastic training on the CPU, held to the JAX package: every case of
`tests/test_elastic_train.py` (the watchdog's `on_trip` escalation, the
detection funnel of a collective abort, a watchdog stall and a reap by
silence into one `WorldChanged`, epoch fencing, quorum, the reform
budget, the fault sites, `StepGuard` rollback that is no reform, a
restart, the heartbeat ticker) and its chaos-smoke scenario
(`tools/train_chaos_smoke.py`: world 8, the busiest pod killed
mid-step, re-formed to 7), each run on both packages: the port's
`EmulatedTrainable` over 8 emulated ranks on the CPU, the JAX package's
over its 8 virtual devices. Every failure path is driven by the fault
registry or an injected clock / wait: no real sleeps.

Held: host logic (reforms, worlds, victims, restored steps, counters,
incarnation fences, dumps) exactly; losses `rtol=1e-5` across the
packages (JAX's tests' tolerance); each package's resumed losses
`repr`-equal to its own uninterrupted reference. The JAX side's
"Elastic:" profiler section is checked on the JAX side only: the port's
profiler is not ported yet. Also the `elastic_train` smoke phase
rehearsed at a tiny width: a `LlamaTrainable` re-formed 4 -> 3 -> 2.
"""
import os
import types

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.distributed.communication.watchdog as jwd
import paddle_tpu.distributed.elastic as jelastic
import paddle_tpu.framework.monitor as jmonitor
import paddle_tpu.observability.timeline as jtimeline
import paddle_tpu.resilience as jres
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.distributed.communication.watchdog as twd
import paddle_tpu_torch.distributed.elastic as telastic
import paddle_tpu_torch.framework.monitor as tmonitor
import paddle_tpu_torch.observability.timeline as ttimeline
import paddle_tpu_torch.resilience as tres
from paddle_tpu_torch.tools import elastic_workload as ew
from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

J = types.SimpleNamespace(
    name="jax", paddle=jpaddle, res=jres, elastic=jelastic, wd=jwd,
    monitor=jmonitor, timeline=jtimeline,
    build=lambda **kw: jres.make_emulated_trainable(**kw))
P = types.SimpleNamespace(
    name="port", paddle=tpaddle, res=tres, elastic=telastic, wd=twd,
    monitor=tmonitor, timeline=ttimeline,
    build=lambda **kw: tres.make_emulated_trainable(device="cpu", **kw))
BOTH = pytest.mark.parametrize("K", [J, P], ids=["jax", "port"])
LOSS = dict(rtol=1e-5, atol=0)


@pytest.fixture(autouse=True)
def _clean_faults():
    for K in (J, P):
        K.res.faults.clear()
    yield
    for K in (J, P):
        K.res.faults.clear()


def make_supervisor(K, tmp_path, n=4, min_world=2, clock=None, ttl=1000.0,
                    build=None, **kw):
    pods = [f"pod{i}" for i in range(n)]
    store_kw = {"ttl": ttl}
    if clock is not None:
        store_kw["clock"] = clock
        kw.setdefault("clock", clock)
    root = tmp_path / K.name
    root.mkdir(parents=True, exist_ok=True)
    store = K.elastic.MembershipStore(str(root / "members.json"), **store_kw)
    mgr_kw = dict(stabilize_s=0.0, sleep=lambda s: None)
    if clock is not None:
        mgr_kw["clock"] = clock
    mgr = K.elastic.ElasticManager(store, min_nodes=1, max_nodes=n, **mgr_kw)
    ckpt = K.res.CheckpointManager(str(root / "ckpt"), keep_last_n=64,
                                   sleep=lambda s: None)
    kw.setdefault("quorum_deadline_s", 5.0)
    sup = K.res.ElasticTrainSupervisor(build or K.build(), mgr, ckpt, pods,
                                       min_world=min_world, save_every=1,
                                       **kw)
    return sup, store, mgr, ckpt


def reference_from_restored(K, sup, ckpt, steps):
    """Unkilled reference at the surviving world, restored from the same
    checkpoint the supervisor resharded from: {step: loss}."""
    tr = K.build()(sup.world)
    ckpt.load(os.path.join(ckpt.root, f"step_{sup.last_restored_step:06d}"),
              state_dict=tr.state_dict(), placements=tr.placements())
    return {i: tr.step(i) for i in range(sup.last_restored_step + 1, steps)}


def on_both(scenario, tmp_path):
    """`scenario(K, tmp_path)` on each package: `(jax, port)`."""
    return scenario(J, tmp_path), scenario(P, tmp_path)


def same_losses(j, t):
    assert sorted(j) == sorted(t)
    np.testing.assert_allclose([t[i] for i in sorted(t)],
                               [j[i] for i in sorted(j)], **LOSS)


# ---------------------------------------------------------------------------
# CommWatchdog escalation
# ---------------------------------------------------------------------------
class TestWatchdogEscalation:
    @BOTH
    def test_handled_trip_suppresses_kill_and_carries_meta(self, K):
        got = []
        now = [100.0]
        trips0 = K.monitor.get("comm.watchdog_trips")

        def handle(exc):
            got.append(exc)
            return True   # the supervisor can re-form in-process

        wd = K.wd.CommWatchdog("all_reduce", timeout=5.0, action="kill",
                               meta={"bytes": 64, "step": 3},
                               clock=lambda: now[0],
                               wait=lambda _t: False, on_trip=handle)
        wd.started_at = now[0]
        now[0] += 9.0
        wd._watch()  # synchronous: would have os._exit(124) unhandled
        assert wd.tripped
        assert K.monitor.get("comm.watchdog_trips") == trips0 + 1
        (exc,) = got
        assert isinstance(exc, K.wd.CollectiveStalled)
        assert exc.op_name == "all_reduce"
        assert exc.meta["bytes"] == 64 and exc.meta["step"] == 3
        assert exc.elapsed_s == 9.0
        assert str(exc) == "collective 'all_reduce' stalled for 9.0s " \
            "(bytes=64)"

    @BOTH
    def test_unhandled_trip_falls_through_to_action(self, K, capsys):
        got = []
        wd = K.wd.CommWatchdog("all_reduce", timeout=5.0, action="log",
                               wait=lambda _t: False, on_trip=got.append)
        wd.started_at = 0.0
        wd._watch()   # action="log": the fall-through is observable
        assert got and wd.tripped
        assert "stuck" in capsys.readouterr().err

    @BOTH
    def test_on_trip_exception_propagates_on_synchronous_drive(self, K):
        def boom(exc):
            raise exc

        wd = K.wd.CommWatchdog("barrier", timeout=1.0, action="log",
                               wait=lambda _t: False, on_trip=boom)
        wd.started_at = 0.0
        with pytest.raises(K.wd.CollectiveStalled):
            wd._watch()

    @BOTH
    def test_raising_hook_never_disarms_the_kill(self, K, monkeypatch):
        """A broken hook that raises on the watchdog thread counts as
        unhandled: the exit-124 last resort still fires first."""
        exits = []
        monkeypatch.setattr(K.wd.os, "_exit", lambda code: exits.append(code))

        def broken(exc):
            raise RuntimeError("bug in the hook")

        wd = K.wd.CommWatchdog("all_reduce", timeout=1.0, action="kill",
                               wait=lambda _t: False, on_trip=broken)
        wd.started_at = 0.0
        with pytest.raises(RuntimeError, match="bug in the hook"):
            wd._watch()
        assert exits == [124]

    @BOTH
    def test_no_trip_no_escalation(self, K):
        got = []
        wd = K.wd.CommWatchdog("barrier", timeout=1.0, action="log",
                               wait=lambda _t: True, on_trip=got.append)
        wd.started_at = 0.0
        wd._watch()
        assert not got and not wd.tripped

    def test_kill_without_hook_exits_124_and_dumps(self, tmp_path,
                                                   monkeypatch):
        """The port's trip writes its `flight_comm_watchdog_*.jsonl`
        naming the collective, then exits 124 (patched: no test process
        may exit)."""
        exits = []
        monkeypatch.setattr(twd.os, "_exit", lambda code: exits.append(code))
        ttimeline.configure(flight_dir=str(tmp_path))
        wd = twd.watchdog_guard("all_gather", timeout=2.0,
                                meta={"bytes": 128})
        wd._wait = lambda _t: False
        wd.started_at = 0.0
        wd._watch()
        assert exits == [124]
        dumps = [f for f in os.listdir(tmp_path)
                 if f.startswith("flight_comm_watchdog_all_gather")]
        assert len(dumps) == 1
        import json
        with open(tmp_path / dumps[0]) as f:
            header = json.loads(f.readline())
        assert header["collective"]["kind"] == "all_gather"
        assert header["collective"]["bytes"] == 128


# ---------------------------------------------------------------------------
# supervisor: detection funnel -> reform -> reshard -> resume
# ---------------------------------------------------------------------------
class TestSupervisorReform:
    def test_happy_path_trains_beats_and_checkpoints(self, tmp_path):
        def scenario(K, tmp_path):
            sup, store, _mgr, ckpt = make_supervisor(K, tmp_path, n=3)
            with sup:
                losses = sup.run(4)
            assert sorted(losses) == [0, 1, 2, 3]
            assert all(np.isfinite(v) for v in losses.values())
            assert sup.reforms == 0 and len(sup.world) == 3
            alive = store.alive()
            assert sorted(alive) == [f"pod{i}" for i in range(3)]
            for ent in alive.values():
                assert ent["payload"]["step"] == 3
                assert ent["payload"]["loss"] == losses[3]
            assert ckpt.latest_valid()[0] == 3
            return losses
        same_losses(*on_both(scenario, tmp_path))

    def test_chaos_kill_reforms_fences_and_resumes_bitwise(self, tmp_path):
        import json

        def scenario(K, tmp_path):
            flight = tmp_path / K.name / "flight"
            K.timeline.configure(flight_dir=str(flight))
            reforms0 = K.monitor.get("elastic.reforms")
            sup, store, _mgr, ckpt = make_supervisor(K, tmp_path, n=4)
            sup.start()
            pre_incs = dict(sup._incarnations)
            K.res.faults.inject("train.step", after_n=3, times=1,
                                action="flag")
            losses = sup.run(8)
            sup.close()
            assert sup.reforms == 1 and len(sup.world) == 3
            assert "pod3" not in sup.world
            assert sup.last_restored_step == 2
            assert len(losses) == 8
            assert K.monitor.get("elastic.reforms") - reforms0 == 1
            assert store.heartbeat("pod0",
                                   incarnation=pre_incs["pod0"]) is False
            assert "pod3" not in store.alive()
            assert sup.last_recovery_ms is not None
            assert K.monitor.get("elastic.recovery_ms") == \
                sup.last_recovery_ms
            ref = reference_from_restored(K, sup, ckpt, 8)
            assert {i: repr(losses[i]) for i in ref} \
                == {i: repr(v) for i, v in ref.items()}
            dumps = [f for f in os.listdir(flight)
                     if f.startswith("flight_elastic_reform")]
            assert dumps
            with open(flight / dumps[0]) as f:
                header = json.loads(f.readline())
                first = json.loads(f.readline())
            assert header["lost_pods"] == ["pod3"]
            assert header["old_world"] != header["new_world"]
            assert first["final_payload"]["step"] == 2
            if K is J:       # the port's profiler is not ported yet
                from paddle_tpu import profiler

                text = profiler.Profiler._elastic_summary_lines()
                assert any("Elastic:" in line for line in text)
            hdr = {k: header[k] for k in ("lost_pods", "old_world",
                                          "new_world", "restored_step",
                                          "cause", "epoch_died",
                                          "epoch_new", "reforms")}
            return losses, hdr, sorted(sup.world)
        (jl, jh, jw), (tl, th, tw) = on_both(scenario, tmp_path)
        same_losses(jl, tl)
        assert jh == th and jw == tw

    def test_raised_collective_error_names_the_lost_pod(self, tmp_path):
        def scenario(K, tmp_path):
            sup, _store, _mgr, ckpt = make_supervisor(K, tmp_path, n=4)
            sup.start()
            K.res.faults.inject(
                "train.step", after_n=2, times=1, action="raise",
                exc=K.res.CollectiveAborted("pod1", "NCCL abort analog"))
            losses = sup.run(5)
            sup.close()
            assert sup.reforms == 1
            assert "pod1" not in sup.world and len(sup.world) == 3
            ref = reference_from_restored(K, sup, ckpt, 5)
            for i, v in ref.items():
                assert repr(losses[i]) == repr(v)
            return losses, sorted(sup.world)
        (jl, jw), (tl, tw) = on_both(scenario, tmp_path)
        same_losses(jl, tl)
        assert jw == tw

    def test_watchdog_stall_escalates_to_reform(self, tmp_path):
        def scenario(K, tmp_path):
            waits = {"n": 0}

            def wait(_timeout):
                waits["n"] += 1
                return waits["n"] != 4

            sup, _store, _mgr, _ckpt = make_supervisor(
                K, tmp_path, n=4, step_timeout_s=60.0, watchdog_wait=wait,
                stall_action="log")
            sup.start()
            losses = sup.run(6)
            sup.close()
            assert sup.reforms == 1 and len(sup.world) == 3
            assert "pod3" not in sup.world
            assert len(losses) == 6
            return losses
        same_losses(*on_both(scenario, tmp_path))

    def test_reap_by_silence_zero_sleep(self, tmp_path):
        def scenario(K, tmp_path):
            now = [0.0]
            base = K.build()

            def build(world):
                tr = base(world)
                orig = tr.step

                def step(i):
                    now[0] += 3.0  # wall time passes while the step runs
                    return orig(i)

                tr.step = step
                return tr

            sup, store, _mgr, ckpt = make_supervisor(
                K, tmp_path, n=4, clock=lambda: now[0], ttl=5.0,
                build=build, reap_timeout_s=5.0)
            sup.start()
            K.res.faults.inject("elastic.beat", after_n=2, times=2,
                                action="flag")
            losses = sup.run(7)
            sup.close()
            assert sup.reforms == 1
            assert "pod3" not in sup.world and len(sup.world) == 3
            assert len(losses) == 7
            ref = reference_from_restored(K, sup, ckpt, 7)
            for i, v in ref.items():
                assert repr(losses[i]) == repr(v)
            return losses, sup.last_restored_step
        (jl, js), (tl, ts) = on_both(scenario, tmp_path)
        same_losses(jl, tl)
        assert js == ts

    @BOTH
    def test_quorum_lost_is_typed(self, K, tmp_path):
        sup, _store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=3,
                                                   min_world=3,
                                                   quorum_deadline_s=0.0)
        sup.start()
        K.res.faults.inject("train.step", after_n=1, times=1, action="flag")
        with pytest.raises(K.res.QuorumLost):
            sup.run(5)
        sup.close()

    @BOTH
    def test_reform_budget_exceeded_is_typed(self, K, tmp_path):
        sup, _store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=4,
                                                   reform_budget=1)
        sup.start()
        K.res.faults.inject("train.step", after_n=2, times=2, action="flag")
        with pytest.raises(K.res.ReformBudgetExceeded):
            sup.run(8)
        sup.close()

    @BOTH
    def test_reform_fault_site_surfaces(self, K, tmp_path):
        sup, _store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=4)
        sup.start()
        K.res.faults.inject("train.step", after_n=1, times=1, action="flag")
        K.res.faults.inject("elastic.reform", times=1)
        with pytest.raises(K.res.faults.InjectedIOError):
            sup.run(5)
        sup.close()

    @BOTH
    def test_reshard_fault_site_surfaces(self, K, tmp_path):
        sup, _store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=4)
        sup.start()
        K.res.faults.inject("train.step", after_n=1, times=1, action="flag")
        K.res.faults.inject("elastic.reshard", times=1)
        with pytest.raises(K.res.faults.InjectedIOError):
            sup.run(5)
        sup.close()
        assert sup.reforms == 1

    def test_nan_rollback_is_guard_business_not_a_reform(self, tmp_path):
        def scenario(K, tmp_path):
            rollbacks0 = K.monitor.get("resilience.rollbacks")
            sup, _store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=3)
            sup.start()
            K.res.faults.inject("guard.nan_loss", after_n=3, times=1,
                                action="flag")
            losses = sup.run(6)
            sup.close()
            assert sup.reforms == 0 and len(sup.world) == 3
            assert K.monitor.get("resilience.rollbacks") - rollbacks0 == 1
            clean_sup, _s2, _m2, _c2 = make_supervisor(K, tmp_path / "clean",
                                                       n=3)
            with clean_sup:
                clean = clean_sup.run(6)
            assert {i: repr(v) for i, v in losses.items()} \
                == {i: repr(v) for i, v in clean.items()}
            return losses
        same_losses(*on_both(scenario, tmp_path))

    def test_restart_resets_per_run_failure_state(self, tmp_path):
        def scenario(K, tmp_path):
            sup, store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=3)
            sup.start()
            K.res.faults.inject("elastic.beat", times=1, action="flag")
            sup.run(2)
            assert sup._silenced == {"pod2"}
            sup.close()
            K.res.faults.clear()
            sup.start()
            losses = sup.run(5)   # resumes at step 2 from the checkpoint
            sup.close()
            assert sup.reforms == 0
            assert sorted(losses) == [2, 3, 4]
            assert store.alive()["pod2"]["payload"]["step"] == 4
            return losses
        same_losses(*on_both(scenario, tmp_path))


# ---------------------------------------------------------------------------
# heartbeat ticker
# ---------------------------------------------------------------------------
class TestHeartbeatTicker:
    @BOTH
    def test_tick_beat_renews_leases_with_last_payloads(self, K, tmp_path):
        now = [0.0]
        sup, store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=3,
                                                  clock=lambda: now[0],
                                                  ttl=10.0)
        sup.start()
        sup.run(2)
        now[0] += 8.0  # a long compile: leases nearly stale
        sup._tick_beat()  # what the ticker thread runs between steps
        alive = store.alive()
        assert sorted(alive) == [f"pod{i}" for i in range(3)]
        for ent in alive.values():
            assert ent["last_heartbeat"] == 8.0
            assert ent["payload"]["step"] == 1  # last real payload kept
        sup.close()

    @BOTH
    def test_ticker_does_not_revive_a_silenced_pod(self, K, tmp_path):
        now = [0.0]
        sup, store, _mgr, _ckpt = make_supervisor(K, tmp_path, n=3,
                                                  clock=lambda: now[0],
                                                  ttl=10.0)
        sup.start()
        K.res.faults.inject("elastic.beat", times=1, action="flag")
        sup.run(1)       # pod2 (busiest tie -> highest id) went silent
        t_before = store.alive()["pod2"]["last_heartbeat"]
        now[0] += 4.0
        sup._tick_beat()
        alive = store.alive()
        assert alive["pod0"]["last_heartbeat"] == 4.0  # renewed
        assert alive["pod2"]["last_heartbeat"] == t_before  # NOT renewed
        sup.close()

    @BOTH
    def test_ticker_thread_lifecycle(self, K, tmp_path):
        ticks = []

        def wait(interval):
            ticks.append(interval)
            return len(ticks) >= 3  # two ticks, then stop

        sup, _store, _mgr, _ckpt = make_supervisor(
            K, tmp_path, n=2, heartbeat_interval_s=0.01, ticker_wait=wait)
        sup.start()
        t = sup._ticker
        assert t is not None
        t.join(timeout=5.0)
        assert not t.is_alive() and len(ticks) == 3
        sup.close()
        assert sup._ticker is None


# ---------------------------------------------------------------------------
# the chaos-smoke scenario and the elastic_train rehearsal
# ---------------------------------------------------------------------------

def _jax_chaos(root):
    """`tools/train_chaos_smoke.py`'s run on the JAX package, in process:
    its losses, victim, world and restored step."""
    pods = [f"pod{i}" for i in range(ew.N_PODS)]
    store = jelastic.MembershipStore(os.path.join(root, "members.json"),
                                     ttl=1000.0)
    mgr = jelastic.ElasticManager(store, min_nodes=1, max_nodes=ew.N_PODS,
                                  stabilize_s=0.0, sleep=lambda s: None)
    ckpt = jres.CheckpointManager(os.path.join(root, "ckpt"),
                                  keep_last_n=ew.STEPS + 1)
    jtimeline.configure(flight_dir=os.path.join(root, "flight"))
    sup = jres.ElasticTrainSupervisor(
        jres.make_emulated_trainable(), mgr, ckpt, pods,
        min_world=ew.MIN_WORLD, save_every=1,
        reform_budget=ew.REFORM_BUDGET, quorum_deadline_s=5.0)
    sup.start()
    jres.faults.inject("train.step", after_n=ew.KILL_AT, times=1,
                       action="flag")
    losses = sup.run(ew.STEPS)
    sup.close()
    return (losses, sorted(set(pods) - set(sup.world)),
            f"{ew.N_PODS}->{len(sup.world)}", sup.last_restored_step,
            sup.trainable.gather())


def test_chaos_smoke_scenario(tmp_path):
    """World 8, the busiest pod killed in the middle of step 7, re-formed
    to 7: the port's run passes every check of the JAX tool (resumed
    losses `repr`-equal to its unkilled world-7 reference, counters,
    gauge, fence, dump, no quarantine, world 8 -> 4 bit for bit), and
    its losses and final state are within 1e-5 of the JAX package's."""
    os.makedirs(tmp_path / "port")
    got = ew.chaos_smoke(tpaddle, str(tmp_path / "port"), device="cpu")
    os.makedirs(tmp_path / "jax")
    jl, jv, jworld, jrest, jstate = _jax_chaos(str(tmp_path / "jax"))
    assert got["victim"] == jv == ["pod7"]
    assert got["world"] == jworld == "8->7"
    assert got["restored"] == jrest == ew.KILL_AT - 1
    assert got["replayed"] == list(range(ew.KILL_AT, ew.STEPS))
    assert got["world4_shards"] == [(2, 8)] * 4
    same_losses(jl, got["losses"])
    for k in jstate:
        np.testing.assert_allclose(got["state"][k], jstate[k], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("world", [4, 2])
def test_emulated_restore_at_world_reslices(tmp_path, world):
    """A world-8 EmulatedTrainable checkpoint restores at `world` with
    every state tensor bit-equal after gather and `world` shards each."""
    tr8 = P.build(seed=5)([f"p{i}" for i in range(8)])
    for i in range(3):
        tr8.step(i)
    cm = tres.CheckpointManager(str(tmp_path / "ckpt"))
    cm.save(2, state_dict=tr8.state_dict())
    trn = P.build(seed=99)([f"p{i}" for i in range(world)])
    assert cm.restore_latest(state_dict=trn.state_dict(),
                             placements=trn.placements()).step == 2
    full8, fulln = tr8.gather(), trn.gather()
    for k in full8:
        np.testing.assert_array_equal(full8[k], fulln[k])
    for k, t in trn.state_dict().items():
        sh = t.local_shards()
        assert len(sh) == world
        assert {tuple(v.shape) for _, _, v in sh} == \
            {(8 // world,) + tuple(t.shape[1:])}


def test_elastic_train_rehearsal(tmp_path):
    """The `elastic_train` smoke phase at a tiny width (`llama_tiny`):
    `LlamaTrainable` (O2 bf16, AdamW, GradScaler, state placed by the
    leading-dim rule) from world 4, a pod killed so it re-forms to 3
    (a tensor split iff its leading dim divides by 3), then to 2 (every
    tensor re-sliced); each resumed
    step's loss `repr`-equal to an uninterrupted run restored from the
    same checkpoint, the final parameters, masters and moments bit-equal
    to that reference's, both lost pods in the dumps with their last
    payloads, a stale incarnation rejected, three saves, no
    quarantine."""
    root = tmp_path / "elastic"
    cm = tres.CheckpointManager(str(root / "ckpt"), keep_last_n=4)
    def build(world):
        return ew.LlamaTrainable(tpaddle, world, tiny=True)

    sup, store, incs, losses, recovery = ew.elastic_run(
        tpaddle, cm, build, [f"pod{i}" for i in range(4)], 7,
        [(4, 4), (3, 2)], str(root / "flight"))
    assert sup.reforms == 2 and sorted(sup.world) == ["pod0", "pod1"]
    assert sorted(losses) == list(range(7))
    assert len(recovery) == 2 and all(r is not None for r in recovery)
    assert store.heartbeat("pod0", incarnation=incs["pod0"]) is False
    dumps = ew.flight_dumps(str(root / "flight"))
    assert [h["lost_pods"] for h, _ in dumps] == [["pod3"], ["pod2"]]
    assert [h["restored_step"] for h, _ in dumps] == [3, 5]
    assert [f["final_payload"]["step"] for _, f in dumps] == [3, 5]
    assert sorted(os.listdir(cm.root)) == ["step_000001", "step_000003",
                                           "step_000005"]
    rep3, tr3 = ew.reference_from_restored(cm, build, ["pod0", "pod1",
                                                       "pod2"], 3, 6)
    assert {i: repr(losses[i]) for i in rep3} == \
        {i: repr(v) for i, v in rep3.items()}
    # the placement rule at world 3: a tensor is split iff its leading
    # dim divides by 3 (at Llama-2-7B width none does)
    for t in tr3.state_dict().values():
        split = t.dim() > 0 and t.shape[0] % 3 == 0
        assert len({o for _, o, _ in tensor_shards(t)}) == \
            (3 if split else 1)
    rep2, tr2 = ew.reference_from_restored(cm, build, ["pod0", "pod1"], 5,
                                           7)
    assert repr(losses[6]) == repr(rep2[6])
    assert ew.state_equal(sup.trainable, tr2) == []
    w = sup.trainable.state_dict()["param.llama.embed_tokens.weight"]
    assert [tuple(v.shape) for _, _, v in tensor_shards(w)] == \
        [(w.shape[0] // 2, w.shape[1])] * 2


def tensor_shards(t):
    from paddle_tpu_torch.distributed.auto_parallel import \
        sharding_bridge as sb
    return sb.local_shards(t)
