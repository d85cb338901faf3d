"""Process-wide named counters and gauges (the port's slice of
`paddle_tpu/framework/monitor.py`): `inc`, `set_gauge`, `get`,
`snapshot` and `reset`.

The serving path bumps `serving.*` counters here. Where the JAX package
counted jit retraces (`serving.{ragged,verify,prefill,decode}_retraces`),
which have no meaning in eager PyTorch, the port counts the engine's
calls: `serving.ragged_steps`, `serving.verify_steps`,
`serving.prefill_steps` and `serving.legacy_decode_steps`. Kernel launch
counts live on the kernel wrappers (`ops/kernels/_support.py`), not
here.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

__all__ = ["inc", "set_gauge", "get", "snapshot", "reset"]

_lock = threading.Lock()
_values: Dict[str, Union[int, float]] = {}


def inc(name: str, n: int = 1) -> int:
    with _lock:
        v = _values.get(name, 0) + n
        _values[name] = v
    return v


def set_gauge(name: str, value) -> None:
    """Set `name` to `value` (a gauge: the last value set wins)."""
    with _lock:
        _values[name] = value


def get(name: str):
    return _values.get(name, 0)


def snapshot(prefix: str = "") -> Dict[str, Union[int, float]]:
    """Every counter and gauge whose name starts with `prefix`."""
    with _lock:
        return {k: v for k, v in _values.items() if k.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Zero every counter whose name starts with `prefix` (all of them by
    default)."""
    with _lock:
        for k in list(_values):
            if k.startswith(prefix):
                del _values[k]
