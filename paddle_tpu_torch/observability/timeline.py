"""Per-request serving timelines and a bounded flight recorder (the
port's copy of `paddle_tpu/observability/timeline.py`).

Every request lifecycle edge (queued, shed / reject, admission, prefill,
each decode / verify round with the tokens it committed, preemption,
relocation between fleet replicas, terminal status) lands here as an
event keyed by request id; engine dispatches, step faults, restarts and
replica deaths land on their own track. Two consumers:

- :func:`chrome_events` renders the events as chrome://tracing tracks —
  pid "serving", one tid (thread) per request plus one for engine
  dispatches, named by metadata events — so a serving trace shows each
  request's whole life next to the dispatches that served it.
- :func:`dump_flight` writes the bounded in-memory ring to
  ``<flight_dir>/flight_<reason>_<pid>_<n>.jsonl`` (``profiler_log`` by
  default, relative to the working directory); the scheduler calls it on
  a step fault, an engine restart and a failed request, the frontend on
  a stall, so the last N events before a failure are on disk.

Everything here is inert until `observability.enable()`: the serving
code checks the enable bool before building any event (no allocation on
the disabled path).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["configure", "flight_dir", "request_event", "dispatch_span",
           "events", "flight_events", "dump_flight", "write_flight_file",
           "dump_elastic_reform", "chrome_events", "reset"]

_lock = threading.Lock()
_ring: deque = deque(maxlen=4096)
_dump_count = 0
_flight_dir = "profiler_log"


def configure(capacity: int = 4096, flight_dir: Optional[str] = None):
    global _ring, _flight_dir
    with _lock:
        if flight_dir is not None:
            _flight_dir = flight_dir
        if capacity != _ring.maxlen:
            _ring = deque(_ring, maxlen=capacity)


def flight_dir() -> str:
    """THE flight-recorder output directory: every forensics producer
    writes here, so one incident's evidence is never scattered across
    directories."""
    with _lock:
        return _flight_dir


def write_flight_file(name: str, header: dict, lines,
                      directory: Optional[str] = None) -> Optional[str]:
    """Shared flight-dump writer: sanitize `name`, number the file,
    write one JSON header line then one JSON line per entry — and never
    raise into the caller (forensics must not compound the failure).
    Returns the path, or None when the write failed."""
    global _dump_count
    with _lock:
        _dump_count += 1
        n = _dump_count
    directory = directory or flight_dir()
    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in name)
    path = os.path.join(directory,
                        f"flight_{safe}_{os.getpid()}_{n}.jsonl")
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps(dict({"flight_recorder": True,
                                     "wall_time": time.time()},
                                    **header)) + "\n")
            for e in lines:
                f.write(json.dumps(e) + "\n")
    except Exception:
        return None
    return path


def reset():
    with _lock:
        _ring.clear()


class Event:
    __slots__ = ("track", "name", "t0", "t1", "req_id", "meta")

    def __init__(self, track, name, t0, t1, req_id, meta):
        self.track = track        # "request" | "dispatch"
        self.name = name
        self.t0 = t0
        self.t1 = t1              # None => instantaneous
        self.req_id = req_id
        self.meta = meta

    def as_dict(self) -> dict:
        d = {"track": self.track, "name": self.name, "t0": self.t0,
             "req_id": self.req_id}
        if self.t1 is not None:
            d["t1"] = self.t1
        if self.meta:
            d["meta"] = self.meta
        return d


def request_event(req_id: int, name: str, t0: float,
                  t1: Optional[float] = None, **meta):
    """One lifecycle edge of request `req_id`. `t0`/`t1` are in the
    scheduler's clock base (perf_counter by default)."""
    with _lock:
        _ring.append(Event("request", name, t0, t1, req_id, meta or None))


def dispatch_span(phase: str, t0: float, t1: Optional[float] = None,
                  **meta):
    """One engine dispatch (prefill/decode/verify) on the engine track;
    `t1=None` renders as an instant marker (restarts, step faults)."""
    with _lock:
        _ring.append(Event("dispatch", phase, t0, t1, None, meta or None))


def events() -> List[Event]:
    with _lock:
        return list(_ring)


def flight_events() -> List[dict]:
    with _lock:
        return [e.as_dict() for e in _ring]


def dump_flight(reason: str, directory: Optional[str] = None) -> Optional[str]:
    """Write the flight ring to `<dir>/flight_<reason>_<pid>_<n>.jsonl`
    (header line first). Returns the path, or None when there is nothing
    recorded. Never raises into the serving path."""
    with _lock:
        evs = [e.as_dict() for e in _ring]
    if not evs:
        return None
    return write_flight_file(reason,
                             {"reason": reason, "events": len(evs)},
                             evs, directory)


def dump_elastic_reform(info: dict, lost_pods: dict,
                        directory: Optional[str] = None) -> Optional[str]:
    """Membership re-formation forensics (always on): one
    ``flight_elastic_reform_*.jsonl`` naming the lost pods with the final
    heartbeat payload each delivered (`MembershipStore.reap_stale(...,
    return_payloads=True)`), then ``info`` (the old and new worlds, the
    fenced epoch, where work resumed) in the header, then the recent
    timeline ring. Never raises into the recovery path."""
    lines = [{"lost_pod": pod, "final_payload": payload}
             for pod, payload in sorted(lost_pods.items())]
    with _lock:
        lines += [e.as_dict() for e in list(_ring)[-64:]]
    return write_flight_file(
        "elastic_reform",
        dict({"reason": "elastic_reform",
              "lost_pods": sorted(lost_pods)}, **info),
        lines, directory)


def chrome_events(base: Optional[float] = None) -> List[dict]:
    """Render the ring as chrome://tracing events: pid "serving", one tid
    per request (named `req <id>`), tid 0 for the engine-dispatch track.
    Instantaneous lifecycle edges render as "i" (instant) events so
    queued/terminal markers show on the request's own track."""
    with _lock:
        evs = list(_ring)
    if not evs:
        return []
    if base is None:
        base = min(e.t0 for e in evs)
    pid = "serving"
    out: List[dict] = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "engine dispatches"}}]
    named = set()
    for e in evs:
        if e.track == "dispatch":
            tid = 0
        else:
            tid = int(e.req_id) + 1
            if tid not in named:
                named.add(tid)
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": f"req {e.req_id}"}})
        ev = {"name": e.name, "pid": pid, "tid": tid, "cat": e.track,
              "ts": (e.t0 - base) * 1e6}
        if e.meta:
            ev["args"] = dict(e.meta)   # copy: never mutate the ring
        if e.req_id is not None:
            ev.setdefault("args", {})["req_id"] = e.req_id
        if e.t1 is None:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=(e.t1 - e.t0) * 1e6)
        out.append(ev)
    return out
