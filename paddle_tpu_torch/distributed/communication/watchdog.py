"""Collective hang watchdog (the port of
`paddle_tpu/distributed/communication/watchdog.py`).

Analog of the reference `CommTaskManager`
(`paddle/phi/core/distributed/comm_task_manager.h:37` +
`nccl_comm_task.cc`): a monitor thread that detects a collective stuck
past its timeout, dumps diagnostics, and (like the NCCL watchdog) can
kill the process with exit 124 so the launcher's failure detection or an
elastic restart takes over.

A trip is observable, not only fatal: it bumps the
``comm.watchdog_trips`` counter and writes a
``flight_comm_watchdog_*.jsonl`` forensics dump naming the stuck
collective's kind, group and bytes (`observability/timeline.py`; the JAX
package adds its comm-trace ring, which is not ported). The clock and
the wait primitive are injectable so tests drive the trip path with zero
sleeps.

Under an escalation supervisor (``on_trip=``), a trip hands the typed
:class:`CollectiveStalled` to the supervisor first; when the supervisor
can handle it in-process (the dispatch returned: fence the mesh epoch,
re-form, resume) the kill / log action is suppressed, and when it cannot
(the caller is still blocked inside the collective) the action fires as
the last resort.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from ...framework import flags

flags.define_flag("comm_timeout_s", 300.0,
                  "collective watchdog timeout in seconds (0 disables)")
flags.define_flag("comm_timeout_action", "kill",
                  "watchdog action on timeout: 'kill' (exit 124, launcher "
                  "restarts) or 'log'")

__all__ = ["CollectiveStalled", "CommWatchdog", "watchdog_guard"]


class CollectiveStalled(RuntimeError):
    """A collective exceeded its watchdog timeout under an escalation
    supervisor: the hang surfaced as a typed, catchable event a
    supervised training loop can fence and re-form around (the elastic
    train supervisor funnels it into ``WorldChanged``)."""

    def __init__(self, op_name: str, meta: Optional[dict] = None,
                 elapsed_s: Optional[float] = None):
        self.op_name = op_name
        self.meta = dict(meta or {})
        self.elapsed_s = elapsed_s
        super().__init__(
            f"collective '{op_name}' stalled"
            + (f" for {elapsed_s:.1f}s" if elapsed_s is not None else "")
            + (f" (bytes={self.meta['bytes']})"
               if "bytes" in self.meta else ""))


def _dump_trip(op_name: str, meta: dict) -> None:
    from ...observability import timeline

    timeline.write_flight_file(
        f"comm_watchdog_{op_name}",
        {"reason": f"comm_watchdog_{op_name}",
         "collective": dict({"kind": op_name}, **meta)},
        timeline.flight_events()[-64:])


class CommWatchdog:
    """Monitors one in-flight communication op (CommTask analog).

    `meta` carries what the trip dump names about the collective
    (payload bytes, group id); `clock` / `wait` are injectable for
    zero-sleep tests: `wait(timeout)` returns True when the op finished
    in time and False on timeout (the `threading.Event.wait` contract).

    ``on_trip`` is the escalation hook: a trip still produces the full
    diagnostics (counter, flight dump, stacks) and then calls
    ``on_trip(CollectiveStalled(...))``. The hook returns whether the
    stall was handled: True suppresses the configured kill / log action;
    False / None falls through to it, because a hook that cannot unwedge
    the blocked caller must not also disarm the watchdog's last resort.
    A hook that raises counts as unhandled. The hook runs on whatever
    thread drives the trip: the watchdog thread for a real hang, the
    caller's thread when a test drives `_watch()` synchronously."""

    def __init__(self, op_name: str, timeout: Optional[float] = None,
                 action: Optional[str] = None, meta: Optional[dict] = None,
                 clock: Callable[[], float] = time.time,
                 wait: Optional[Callable[[float], bool]] = None,
                 on_trip: Optional[Callable[[CollectiveStalled], None]]
                 = None):
        self.op_name = op_name
        self.timeout = (flags.flag_value("comm_timeout_s")
                        if timeout is None else float(timeout))
        self.action = action or flags.flag_value("comm_timeout_action")
        self.meta = dict(meta or {})
        self.on_trip = on_trip
        self.tripped = False
        self._clock = clock
        self._done = threading.Event()
        self._wait = wait if wait is not None else self._done.wait
        self._thread = None
        self.started_at = None

    def start(self):
        if not self.timeout or self.timeout <= 0:
            return self
        self.started_at = self._clock()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def finish(self):
        self._done.set()

    def _watch(self):
        if self._wait(self.timeout):
            return
        self._trip()

    def _trip(self):
        """The timeout path: diagnostics first (counter, forensics dump,
        stacks), then the configured action."""
        from ...framework import monitor

        started = self.started_at if self.started_at is not None \
            else self._clock()
        elapsed = self._clock() - started
        rank = os.environ.get("PADDLE_TRAINER_ID", "?")
        self.tripped = True
        monitor.inc("comm.watchdog_trips")
        try:
            self.meta.setdefault("group", 0)
            self.meta["elapsed_s"] = round(elapsed, 1)
            self.meta["timeout_s"] = self.timeout
            self.meta["rank"] = rank
            _dump_trip(self.op_name, self.meta)
        except Exception:
            pass   # forensics must never mask the hang diagnostics
        sys.stderr.write(
            f"[paddle_tpu_torch comm watchdog] rank {rank}: collective "
            f"'{self.op_name}' stuck for {elapsed:.1f}s "
            f"(timeout {self.timeout}s, "
            f"bytes={self.meta.get('bytes', '?')}, "
            f"group={self.meta.get('group', '?')}). Stacks:\n")
        for tid, frame in sys._current_frames().items():
            sys.stderr.write(f"--- thread {tid} ---\n")
            sys.stderr.write("".join(traceback.format_stack(frame)))
        sys.stderr.flush()
        if self.on_trip is not None:
            # escalation first: only a HANDLED stall suppresses the
            # action; a hook that raises counts as unhandled, or on the
            # watchdog thread its exception would kill the thread before
            # the exit-124 last resort
            handled, hook_exc = False, None
            try:
                handled = bool(self.on_trip(
                    CollectiveStalled(self.op_name, dict(self.meta),
                                      elapsed_s=elapsed)))
            except BaseException as e:  # noqa: BLE001 (arbitrary hooks)
                hook_exc = e
            if handled:
                return
            if self.action == "kill":
                os._exit(124)
            if hook_exc is not None:
                raise hook_exc  # surfaces on a synchronous drive
            return
        if self.action == "kill":
            # exit 124: the launcher's watcher treats it as a failure and
            # (elastic mode) relaunches (the NCCL-watchdog abort path)
            os._exit(124)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.finish()
        return False


def watchdog_guard(op_name: str, timeout: Optional[float] = None,
                   action: Optional[str] = None,
                   meta: Optional[dict] = None,
                   on_trip=None) -> CommWatchdog:
    """Context manager guarding one collective call:

    with watchdog_guard("all_reduce", meta={"bytes": payload_bytes}):
        <blocking collective>
    """
    return CommWatchdog(op_name, timeout, action, meta=meta,
                        on_trip=on_trip)
