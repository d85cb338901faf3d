"""Deterministic fault-injection registry (the port's copy of
`paddle_tpu/resilience/faults.py`).

A test arms a named site — ``inject("serve.decode", after_n=3)`` — and
the instrumented serving code calls ``check(site)`` / ``check_flag(site)``
there. Counting is pure arithmetic over call order, so an injection
schedule replays identically on every run: no clocks, no randomness, no
sleeps.

Fault kinds (``action``):
- ``"raise"``  — raise ``exc`` (default :class:`InjectedIOError`) at the
  site: transient or permanent failures, step exceptions.
- ``"kill"``   — ``SIGKILL`` the current process (hard preemption).
- ``"sigterm"``— deliver ``SIGTERM`` to the current process.
- ``"flag"``   — no side effect at ``check``; the site observes it via
  :func:`check_flag` or :func:`fires` and applies the fault itself.

Serving sites: ``serve.decode`` / ``serve.verify`` (per engine dispatch
in `serving/scheduler.py`; the ragged step fires ``serve.decode``;
``action="flag"`` asks the scheduler to poison one lane's logits with
NaN instead of raising), ``serve.sample`` (per sampler call) and
``serve.cache`` (per `BlockCacheManager.allocate` / `adopt` /
`append_tokens`) and ``serve.adapter`` (per adapter-pool miss in
`serving/lora.py`, before the pool is touched: an armed fault fails the
admitting request as ``engine_fault:adapter``). An ``exc`` that is an `serving.EngineStepError` with
``seq_ids`` drives the targeted lane-isolation path; the default
`InjectedIOError` drives the transient-retry path.
"""
from __future__ import annotations

import os
import signal as _signal
import threading
from typing import Dict, Optional

__all__ = ["InjectedFault", "InjectedIOError", "inject", "clear", "check",
           "check_flag", "fires", "state"]


class InjectedFault(Exception):
    """Base class for all injected failures."""


class InjectedIOError(InjectedFault, IOError):
    """Injected transient or permanent I/O failure (an ``OSError``
    subclass, so it flows through `framework.retry`'s default
    ``retry_on``)."""


class _Rule:
    __slots__ = ("site", "after_n", "times", "action", "exc", "calls",
                 "fired")

    def __init__(self, site, after_n, times, action, exc):
        self.site = site
        self.after_n = int(after_n)   # calls that pass before firing starts
        self.times = times            # firings allowed; None = unlimited
        self.action = action
        self.exc = exc
        self.calls = 0                # calls seen
        self.fired = 0                # firings delivered


_rules: Dict[str, _Rule] = {}
_lock = threading.Lock()


def inject(site: str, after_n: int = 0, times: Optional[int] = 1,
           action: str = "raise", exc=None) -> None:
    """Arm ``site``: the first ``after_n`` calls pass, then the next
    ``times`` calls fire (``times=None`` fires forever)."""
    if action not in ("raise", "kill", "sigterm", "flag"):
        raise ValueError(f"unknown fault action {action!r}")
    with _lock:
        _rules[site] = _Rule(site, after_n, times, action,
                             exc or InjectedIOError(f"injected fault at "
                                                    f"'{site}'"))


def clear(site: Optional[str] = None) -> None:
    """Disarm one site, or every site when ``site`` is None."""
    with _lock:
        if site is None:
            _rules.clear()
        else:
            _rules.pop(site, None)


def _consume(site: str) -> Optional[_Rule]:
    """Count one call at ``site``; return the rule iff this call fires."""
    if not _rules:   # fast path: unarmed hot paths pay one dict check
        return None
    with _lock:
        rule = _rules.get(site)
        if rule is None:
            return None
        rule.calls += 1
        if rule.calls <= rule.after_n:
            return None
        if rule.times is not None and rule.fired >= rule.times:
            return None
        rule.fired += 1
        return rule


def fires(site: str) -> bool:
    """Count one call; True iff the site fires now (``"flag"`` sites,
    where the caller applies the fault itself)."""
    return _consume(site) is not None


def check(site: str) -> None:
    """Count one call; deliver the armed fault (raise / kill / sigterm)
    if this call fires. A ``"flag"`` rule never raises from ``check``."""
    check_flag(site)


def check_flag(site: str) -> bool:
    """:func:`check`, and also report whether a ``"flag"`` rule fired at
    THIS call. One call = one count."""
    rule = _consume(site)
    if rule is None:
        return False
    if rule.action == "flag":
        return True
    if rule.action == "kill":
        os.kill(os.getpid(), _signal.SIGKILL)
    if rule.action == "sigterm":
        os.kill(os.getpid(), _signal.SIGTERM)
        return False  # handler (if any) ran; the site continues
    raise rule.exc


def state() -> Dict[str, Dict[str, int]]:
    """Introspection for tests: per-site call/fire counts."""
    with _lock:
        return {s: {"calls": r.calls, "fired": r.fired,
                    "after_n": r.after_n,
                    "times": -1 if r.times is None else r.times}
                for s, r in _rules.items()}
