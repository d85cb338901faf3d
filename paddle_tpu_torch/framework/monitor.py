"""Process-wide named counters and gauges (the port's slice of
`paddle_tpu/framework/monitor.py`): `inc`, `set_gauge`, `get`,
`observe` (fixed-bucket histograms), `snapshot` and `reset`.

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

__all__ = ["inc", "set_gauge", "get", "observe", "snapshot", "reset"]

_lock = threading.Lock()
_values: Dict[str, Union[int, float]] = {}
# histogram name -> [counts per bucket (+inf last), sum, count]
_hists: Dict[str, list] = {}
# the JAX monitor's default bucket bounds
_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


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


def observe(name: str, value: float) -> None:
    """Record one sample into the fixed-bucket histogram `name` (the JAX
    monitor's default bounds)."""
    with _lock:
        h = _hists.setdefault(name, [[0] * (len(_BUCKETS) + 1), 0.0, 0])
        h[0][next((i for i, b in enumerate(_BUCKETS) if value <= b),
                  len(_BUCKETS))] += 1
        h[1] += value
        h[2] += 1


def snapshot(prefix: str = "") -> Dict[str, Union[int, float]]:
    """Every counter and gauge whose name starts with `prefix`, and each
    such histogram as the JAX monitor flattens it: cumulative
    `<name>_bucket_le_<bound>` counts, `<name>_sum` and `<name>_count`."""
    with _lock:
        out = {k: v for k, v in _values.items() if k.startswith(prefix)}
        for name, (counts, total, n) in _hists.items():
            if not name.startswith(prefix):
                continue
            cum = 0
            for b, c in zip(_BUCKETS, counts):
                cum += c
                out[f"{name}_bucket_le_{b:g}"] = cum
            out[f"{name}_bucket_le_inf"] = cum + counts[-1]
            out[f"{name}_sum"] = round(total, 6)
            out[f"{name}_count"] = n
        return out


def reset(prefix: str = "") -> None:
    """Zero every counter, gauge and histogram whose name starts with
    `prefix` (all of them by default)."""
    with _lock:
        for store in (_values, _hists):
            for k in list(store):
                if k.startswith(prefix):
                    del store[k]
