"""paddle_tpu_torch.observability — the serving path's own evidence (the
port's slice of `paddle_tpu/observability/`): the per-request serving
timeline and its bounded flight recorder (`timeline.py`).

Everything is OFF by default and costs nothing while off: every
instrumented site checks one module-level bool (`enabled()`) before it
builds an event, so the disabled path allocates nothing.
"""
from __future__ import annotations

__all__ = ["enable", "disable", "enabled"]

_enabled = False


def enabled() -> bool:
    """The one-bool gate every instrumented site checks first: a plain
    module attribute read, which IS the disabled path's cost."""
    return _enabled


def enable(flight_capacity: int = 4096):
    """Turn the timeline on (idempotent). `flight_capacity` bounds the
    in-memory flight recorder (events, not bytes)."""
    global _enabled
    from . import timeline

    timeline.configure(flight_capacity)
    _enabled = True


def disable():
    global _enabled
    _enabled = False
