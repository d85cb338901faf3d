"""The serving timeline on the port (`paddle_tpu_torch.observability`):
the request-timeline and flight-recorder scenarios of
`tests/test_observability.py` (the disabled path records nothing; a
request's lifecycle and its chrome://tracing tracks; a flight dump on an
injected fault) on the port with their own assertions, the rest of the
timeline module's surface (the ring's capacity, the shared flight
writer, the membership re-formation dump, the stall, restart and
failed-request dumps, preemption and speculative rounds), and the same
serving scenarios on both packages with each request's events compared:
names in order and every field but the clock readings. The JAX side
runs its MLP engine (no Pallas body); its profiler, compile tracing and
cost cards have no counterpart here."""
import json
import os

import numpy as np
import pytest

import paddle_tpu.serving as jserving
from paddle_tpu import observability as jobs
from paddle_tpu.resilience import faults as jfaults
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import mlp_from_jax_params
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import timeline
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (AdmissionConfig, EngineStalled,
                                      MLPLMEngine, NGramProposer,
                                      RequestStatus, ServingFrontend,
                                      SpecDecodeConfig, WatchdogConfig)

CFG = dict(vocab_size=64, hidden=16, max_batch_size=4, num_blocks=48,
           block_size=4, max_blocks_per_seq=8)


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    dirs = [o.timeline.flight_dir() for o in (obs, jobs)]
    for o, f in ((obs, faults), (jobs, jfaults)):
        o.disable()
        o.timeline.reset()
        f.clear()
        o.timeline.configure(flight_dir=str(tmp_path / "flights"))
    yield
    for (o, f), d in zip(((obs, faults), (jobs, jfaults)), dirs):
        o.disable()
        o.timeline.reset()
        f.clear()
        o.timeline.configure(4096, flight_dir=d)


def _engine(**kw):
    return MLPLMEngine(**{**CFG, **kw}, device="cpu")


def _mlp_frontend(**kw):
    fe_kw = {k: kw.pop(k) for k in list(kw)
             if k in ("spec", "admission", "watchdog", "engine_factory",
                      "stall_after", "max_queue")}
    return ServingFrontend(_engine(**kw), **fe_kw)


def _flights(d):
    return sorted(f for f in os.listdir(d) if f.startswith("flight_")) \
        if os.path.isdir(d) else []


def test_disabled_records_nothing():
    assert not obs.enabled()
    fe = _mlp_frontend()
    rng = np.random.default_rng(0)
    hs = [fe.submit(rng.integers(1, 64, n).tolist(), max_new_tokens=3)
          for n in (3, 6, 9)]
    fe.run_until_idle()
    assert all(h.status is RequestStatus.FINISHED for h in hs)
    assert timeline.events() == []
    assert hs[0].timeline() == []
    assert timeline.chrome_events() == []
    assert timeline.dump_flight("nothing") is None


def test_request_timeline_lifecycle_and_chrome_tracks():
    obs.enable()
    fe = _mlp_frontend()
    rng = np.random.default_rng(1)
    hs = [fe.submit(rng.integers(1, 64, n).tolist(), max_new_tokens=4)
          for n in (3, 7)]
    fe.run_until_idle()
    names = [e["name"] for e in hs[0].timeline()]
    for needed in ("queued", "admitted", "prefill", "decode"):
        assert needed in names, names
    assert names[-1].startswith("terminal:finished")
    dec = [e for e in hs[0].timeline() if e["name"] == "decode"]
    assert all(e["meta"]["tokens"] == 1 for e in dec)
    ev = [e for e in timeline.chrome_events() if e.get("ph") != "M"]
    tids = {e["tid"] for e in ev}
    assert 0 in tids and len(tids) >= 3   # engine track + 2 request tracks
    assert all(e["args"]["req_id"] is not None for e in ev if e["tid"] != 0)
    assert all(e["ts"] >= 0 for e in ev)
    assert {e["name"] for e in ev if e["tid"] == 0} == {"decode"}
    # the export must not have mutated the ring's stored meta dicts
    assert all("req_id" not in e["meta"] for e in dec)
    # a disabled read never returns the stale ring
    obs.disable()
    assert hs[0].timeline() == []


def test_flight_recorder_dumps_on_injected_fault(tmp_path):
    obs.enable()
    fe = _mlp_frontend()
    rng = np.random.default_rng(0)
    faults.inject("serve.decode", after_n=1, times=1)
    hs = [fe.submit(rng.integers(1, 64, 4).tolist(), max_new_tokens=4)
          for _ in range(2)]
    fe.run_until_idle()
    assert all(h.status is RequestStatus.FINISHED for h in hs)
    d = tmp_path / "flights"
    flights = _flights(d)
    assert flights
    lines = [json.loads(ln) for ln in open(d / flights[0])]
    assert lines[0]["flight_recorder"] and lines[0]["reason"].startswith(
        "step_fault")
    assert lines[0]["events"] == len(lines) - 1
    assert any(e.get("name") == "queued" for e in lines[1:])
    assert any(e.get("name") == "step_fault:decode" for e in lines[1:])


def test_restart_and_failed_request_dump(tmp_path):
    obs.enable()
    fe = _mlp_frontend(watchdog=WatchdogConfig(step_retries=0,
                                               max_restarts=1),
                       engine_factory=_engine)
    faults.inject("serve.decode", after_n=1, times=None)
    h = fe.submit(list(range(1, 6)), max_new_tokens=4)
    fe.run_until_idle(max_steps=200)
    assert h.status is RequestStatus.FAILED
    assert h.finish_reason.startswith("engine_unrecoverable")
    names = [e["name"] for e in h.timeline()]
    assert "preempted" in names and names[-1] == "terminal:failed"
    pre = [e for e in h.timeline() if e["name"] == "preempted"][0]
    assert pre["meta"]["reason"].startswith("restart:")
    reasons = [f.split("_")[1] for f in _flights(tmp_path / "flights")]
    assert {"engine", "request", "step"} <= set(reasons)
    spans = [e.name for e in timeline.events() if e.track == "dispatch"]
    assert any(s.startswith("engine_restart:") for s in spans)


def test_stall_dumps_before_raising(tmp_path):
    obs.enable()
    fe = _mlp_frontend(stall_after=3)
    faults.inject("serve.decode", after_n=0, times=None)
    # no watchdog and a step-fault count that never reaches its
    # escalation limit: every round faults, nothing progresses (a wedge)
    fe.scheduler._step_faults = -10**9
    fe.submit(list(range(1, 6)), max_new_tokens=4)
    with pytest.raises(EngineStalled):
        fe.run_until_idle(max_steps=50)
    assert any("engine_stalled" in f for f in _flights(tmp_path / "flights"))


def test_preemption_and_rejections_are_events():
    obs.enable()
    fe = _mlp_frontend(num_blocks=6, max_blocks_per_seq=4)
    hs = [fe.submit(list(range(1, 7)), max_new_tokens=9) for _ in range(3)]
    bad = fe.submit([], max_new_tokens=2)
    fe.run_until_idle()
    assert bad.timeline()[-1]["name"] == "terminal:rejected"
    assert bad.timeline()[-1]["meta"]["reason"] == "empty_prompt"
    preempted = [e for h in hs for e in h.timeline()
                 if e["name"] == "preempted"]
    assert preempted and all(e["meta"]["reason"] == "kv_pressure"
                             for e in preempted)
    shed_fe = _mlp_frontend(admission=AdmissionConfig(queue_high=1))
    shed = [shed_fe.submit([1, 2, 3], max_new_tokens=2) for _ in range(4)]
    assert any(h.timeline()[-1]["name"] == "terminal:shed" for h in shed)


def test_spec_rounds_are_verify_events():
    obs.enable()
    fe = _mlp_frontend(spec=SpecDecodeConfig(NGramProposer(), 3))
    h = fe.submit([1, 2, 3, 1, 2, 3, 1, 2], max_new_tokens=6)
    fe.run_until_idle()
    rounds = [e for e in h.timeline() if e["name"] == "verify_round"]
    assert rounds
    assert sum(e["meta"]["tokens"] for e in rounds) == len(h.tokens) - 1
    assert all(e["meta"]["accepted"] <= e["meta"]["drafts"]
               for e in rounds)
    assert {e.name for e in timeline.events()
            if e.track == "dispatch"} == {"verify"}


def test_ring_capacity_and_flight_writer(tmp_path):
    obs.enable(flight_capacity=4)
    for i in range(10):
        timeline.request_event(7, f"e{i}", float(i))
    assert [e.name for e in timeline.events()] == ["e6", "e7", "e8", "e9"]
    path = timeline.dump_flight("cap/test", directory=str(tmp_path))
    assert os.path.basename(path).startswith("flight_cap_test_")
    header = json.loads(open(path).readline())
    assert header["reason"] == "cap/test" and header["events"] == 4
    # the writer never raises: an unwritable directory answers None
    open(tmp_path / "blocker", "w").close()
    assert timeline.write_flight_file(
        "x", {}, [{"a": 1}], directory=str(tmp_path / "blocker")) is None
    reform = timeline.dump_elastic_reform(
        {"old_world": ["a", "b"], "new_world": ["a"]},
        {"b": {"step": 3}}, directory=str(tmp_path))
    lines = [json.loads(ln) for ln in open(reform)]
    assert lines[0]["lost_pods"] == ["b"]
    assert lines[0]["new_world"] == ["a"]
    assert lines[1] == {"lost_pod": "b", "final_payload": {"step": 3}}
    assert len(lines) == 2 + 4


# ---------------------------------------------------------------------------
# the same serving scenarios on both packages
# ---------------------------------------------------------------------------

_CLOCK_KEYS = ("queue_wait_ms",)


def _events(handles):
    out = []
    for h in handles:
        evs = []
        for e in h.timeline():
            meta = {k: v for k, v in (e.get("meta") or {}).items()
                    if k not in _CLOCK_KEYS}
            evs.append((e["name"], "t1" in e, meta))
        out.append(evs)
    return out


def _scenario(serving, o, f, factory, spec, fault):
    o.enable()
    o.timeline.reset()
    kw = {}
    if spec:
        kw["spec"] = serving.SpecDecodeConfig(serving.NGramProposer(), 3)
    fe = serving.ServingFrontend(factory(), **kw)
    if fault:
        f.inject("serve.decode", after_n=2, times=1)
    rng = np.random.default_rng(3)
    hs = [fe.submit(rng.integers(1, 64, n).tolist(), max_new_tokens=5)
          for n in (3, 9, 14, 5, 6)]
    hs.append(fe.submit([], max_new_tokens=2))
    fe.run_until_idle()
    f.clear()
    dispatch = [e.name for e in o.timeline.events() if e.track == "dispatch"]
    events = _events(hs)
    o.disable()
    return [h.tokens for h in hs], events, dispatch


@pytest.mark.parametrize("spec,fault", [(False, False), (True, False),
                                        (False, True)],
                         ids=["plain", "spec", "step_fault"])
def test_events_match_jax(spec, fault):
    jax_engine = jserving.MLPLMEngine(**{**CFG, "num_blocks": 12})
    params = {k: np.asarray(v) for k, v in jax_engine.params.items()}

    def port_engine():
        return mlp_from_jax_params(params, MLPLMEngine(
            **{**CFG, "num_blocks": 12}, device="cpu"))

    j = _scenario(jserving, jobs, jfaults, lambda: jax_engine, spec, fault)
    t = _scenario(tserving, obs, faults, port_engine, spec, fault)
    assert t == j
    names = {n for evs in j[1] for n, _t1, _m in evs}
    assert {"queued", "admitted", "terminal:finished",
            "terminal:rejected"} <= names
    if spec:
        assert "verify_round" in names
    else:
        assert "decode" in names
    if not spec:
        assert "preempted" in names   # 12 blocks: the pool runs short
