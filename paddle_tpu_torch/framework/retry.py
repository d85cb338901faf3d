"""Bounded retry with exponential backoff, deterministic jitter and a
wall-clock deadline (the port's copy of `paddle_tpu/framework/retry.py`).

The serving watchdog spends its lifetime engine-restart budget through
`Budget` and rebuilds an engine through `retry_call`. Standard library
only, apart from the port's monitor for the retry counters.
"""
from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional, Tuple, Type

from . import monitor

__all__ = ["Budget", "RetryDeadlineExceeded", "retry_call"]


class RetryDeadlineExceeded(TimeoutError):
    """The deadline lapsed before an attempt succeeded. `__cause__` holds
    the last underlying failure."""


def _count(monitor_name: Optional[str], delta: int = 1) -> None:
    if monitor_name:
        monitor.inc(monitor_name, delta)


class Budget:
    """A spend-down budget shared ACROSS calls — the lifetime analog of
    `retry_call`'s per-call ``retries``. Each recovery calls
    :meth:`spend`, which answers False once ``limit`` uses are gone, and
    the caller degrades to its terminal path instead of looping forever
    (the serving watchdog's engine restarts)."""

    def __init__(self, limit: int, monitor_name: Optional[str] = None):
        self.limit = int(limit)
        self.used = 0
        self.monitor_name = monitor_name

    @property
    def remaining(self) -> int:
        return max(0, self.limit - self.used)

    def spend(self) -> bool:
        """Consume one use; False (and no side effects) when exhausted."""
        if self.used >= self.limit:
            return False
        self.used += 1
        _count(self.monitor_name)
        return True


def retry_call(fn: Callable, *args,
               retries: int = 3,
               base_delay: float = 0.05,
               max_delay: float = 2.0,
               jitter: float = 0.1,
               deadline: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               monitor_name: Optional[str] = "framework.retries",
               on_retry: Optional[Callable] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               seed: Optional[int] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; on an exception in ``retry_on`` sleep
    ``min(max_delay, base_delay * 2**attempt)`` (plus up to ``jitter``
    fraction of jitter) and try again, at most ``retries`` more times and
    never past ``deadline`` seconds of total elapsed time.

    Jitter is seeded per process by default (pid-derived), so processes
    contending for one resource do not replay identical backoff
    schedules; ``seed`` replays one schedule exactly.

    Each retry (not the first attempt) bumps ``monitor_name`` and calls
    ``on_retry(attempt, exc, delay)``. Exhausting ``retries`` re-raises
    the last exception; blowing ``deadline`` raises
    :class:`RetryDeadlineExceeded` from it. ``sleep`` and ``clock`` are
    injectable, so tests run with zero real sleeps.
    """
    rng = random.Random(os.getpid() if seed is None else seed)
    start = clock()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as exc:
            if attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2.0 ** attempt))
            if jitter:
                delay *= 1.0 + jitter * rng.random()
            if deadline is not None and (clock() - start) + delay > deadline:
                raise RetryDeadlineExceeded(
                    f"retry deadline ({deadline}s) exceeded after "
                    f"{attempt + 1} attempt(s): {exc!r}") from exc
            _count(monitor_name)
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
            attempt += 1
