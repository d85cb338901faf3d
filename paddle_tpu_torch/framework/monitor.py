"""Process-wide named counters and gauges (the port's slice of
`paddle_tpu/framework/monitor.py`): `inc`, `set_gauge`, `get`,
`observe` (fixed-bucket histograms), `snapshot`, `reset`,
`reset_prefix` and `aggregate_mesh` (the cross-host view the serving
fleet reports through).

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
from typing import Dict, Optional, Union

__all__ = ["inc", "set_gauge", "get", "observe", "snapshot",
           "aggregate_mesh", "reset", "reset_prefix"]

_lock = threading.Lock()
_values: Dict[str, Union[int, float]] = {}
# histogram name -> [bucket bounds, counts per bucket (+inf last), sum,
# count]
_hists: Dict[str, list] = {}
# the JAX monitor's default bucket bounds
_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
_STEP_WALL_SPREAD_BUCKETS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                             5000.0)


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


def observe(name: str, value: float, buckets=None) -> None:
    """Record one sample into the fixed-bucket histogram `name`. Its
    bounds are frozen by the first sample (`buckets`, or the JAX
    monitor's default bounds); asking for different bounds later
    raises."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            bounds = tuple(sorted(float(b) for b in buckets)) if buckets \
                else _BUCKETS
            h = _hists[name] = [bounds, [0] * (len(bounds) + 1), 0.0, 0]
        elif buckets is not None and tuple(
                sorted(float(b) for b in buckets)) != h[0]:
            raise ValueError(f"histogram {name!r} already has buckets "
                             f"{h[0]}; cannot re-register with "
                             f"{tuple(buckets)}")
        bounds = h[0]
        h[1][next((i for i, b in enumerate(bounds) if value <= b),
                  len(bounds))] += 1
        h[2] += value
        h[3] += 1


def snapshot(prefix: str = "", include_histograms: bool = True
             ) -> Dict[str, Union[int, float]]:
    """Every counter and gauge whose name starts with `prefix`, and
    (unless `include_histograms=False`) each such histogram as the JAX
    monitor flattens it: cumulative `<name>_bucket_le_<bound>` counts,
    `<name>_sum` and `<name>_count`."""
    prefix = prefix or ""
    with _lock:
        out = {k: v for k, v in _values.items() if k.startswith(prefix)}
        for name, (bounds, counts, total, n) in _hists.items():
            if not include_histograms or not name.startswith(prefix):
                continue
            cum = 0
            for b, c in zip(bounds, counts):
                cum += c
                out[f"{name}_bucket_le_{b:g}"] = cum
            out[f"{name}_bucket_le_inf"] = cum + counts[-1]
            out[f"{name}_sum"] = round(total, 6)
            out[f"{name}_count"] = n
        return out


def aggregate_mesh(prefix: str = "", snapshots: Optional[list] = None,
                   step_wall_key: str = "mesh.step_wall_ms") -> Dict:
    """Cross-host aggregation of `snapshot()`: numeric values summed into
    ``sum``; each host's `step_wall_key` value feeds the straggler
    attribution (the slowest host in ``straggler_host`` and the
    `mesh.straggler_host` gauge, every host's wall into the
    `mesh.step_wall_spread` histogram, ``step_wall_spread_pct`` =
    ``(max / min - 1) * 100`` over the non-zero walls).

    `snapshots` is a pre-collected list, one dict per host (the serving
    fleet passes its replicas'). Without it, this process's snapshot is
    gathered with `torch.distributed.all_gather_object` when a default
    process group of more than one rank is initialised, and used alone
    otherwise."""
    if snapshots is None:
        local = snapshot(prefix, include_histograms=False)
        if step_wall_key not in local:
            w = get(step_wall_key)
            if w:
                local[step_wall_key] = w
        snapshots = [local]
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, local)
            snapshots = [dict(s) for s in gathered]
    hosts = len(snapshots)
    agg: Dict[str, float] = {}
    for s in snapshots:
        for k, v in s.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                agg[k] = agg.get(k, 0) + v
    walls = [float(s.get(step_wall_key, 0) or 0) for s in snapshots]
    out: Dict[str, object] = {"hosts": hosts,
                              "per_host_step_wall_ms": walls, "sum": agg}
    set_gauge("mesh.hosts", hosts)
    inc("mesh.aggregations")
    if any(walls):
        straggler = max(range(hosts), key=lambda r: walls[r])
        nonzero = [w for w in walls if w > 0]
        spread_pct = round((max(nonzero) / min(nonzero) - 1.0) * 100.0, 2)
        out["straggler_host"] = straggler
        out["straggler_step_wall_ms"] = walls[straggler]
        out["step_wall_spread_pct"] = spread_pct
        set_gauge("mesh.straggler_host", straggler)
        set_gauge("mesh.step_wall_spread_pct", spread_pct)
        for w in walls:
            observe("mesh.step_wall_spread", w,
                    buckets=_STEP_WALL_SPREAD_BUCKETS)
    else:
        out["straggler_host"] = None
        out["step_wall_spread_pct"] = None
    return out


def reset(prefix: str = "") -> None:
    """Zero every counter, gauge and histogram whose name starts with
    `prefix` (all of them by default)."""
    with _lock:
        for store in (_values, _hists):
            for k in list(store):
                if k.startswith(prefix):
                    del store[k]


def reset_prefix(prefix: str) -> None:
    """Zero (rather than drop) every counter, gauge and histogram whose
    name starts with `prefix`: they stay in `snapshot()` at 0, as the
    JAX monitor's do."""
    with _lock:
        for k in _values:
            if k.startswith(prefix):
                _values[k] = 0
        for k, h in _hists.items():
            if k.startswith(prefix):
                h[1:] = [[0] * (len(h[0]) + 1), 0.0, 0]
