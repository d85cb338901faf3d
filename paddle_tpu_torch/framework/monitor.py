"""Process-wide metrics registry: the port of
`paddle_tpu/framework/monitor.py`, its whole surface and semantics.

Named counters (`inc`, `set_value`, `set_max`), gauges (`set_gauge`: a
value that goes up and down, typed so `render_prometheus` declares it a
gauge) and fixed-bucket histograms (`observe`). `snapshot()` flattens
everything into one dict (a histogram expands into cumulative
`<name>_bucket_le_<bound>` counts, `<name>_sum` and `<name>_count`), and
`render_prometheus()` writes the text exposition format. `reset(name)`
zeroes one counter or histogram and `reset_prefix(prefix)` every one
under a prefix; both keep the names in `snapshot()` at 0, and
`reset_all()` zeroes everything.

`aggregate_mesh` is the cross-host view: every host's snapshot summed,
the per-host step walls turned into the straggler attribution. The
serving fleet passes its replicas' snapshots; without them a default
`torch.distributed` group of more than one rank gathers them.

The serving path bumps `serving.*` names here. Where the JAX package
counted jit retraces (`serving.{ragged,verify,prefill,decode}_retraces`),
which have no meaning in eager PyTorch, the port counts the engine's
calls: `serving.ragged_steps`, `serving.verify_steps`,
`serving.prefill_steps` and `serving.legacy_decode_steps`. Kernel launch
counts live on the kernel wrappers (`ops/kernels/_support.py`), not
here.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Sequence

__all__ = ["register_counter", "counter", "inc", "set_value", "set_max",
           "set_gauge", "observe", "histogram", "get", "get_all",
           "snapshot", "aggregate_mesh", "render_prometheus", "reset",
           "reset_prefix", "reset_all", "Counter", "Histogram"]


class Counter:
    """One named counter or gauge (int or float)."""

    __slots__ = ("name", "_value", "_lock", "kind")

    def __init__(self, name: str, kind: str = "counter"):
        self.name = name
        self.kind = kind          # "counter" | "gauge" (the Prometheus TYPE)
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, delta=1):
        with self._lock:
            self._value += delta
            return self._value

    def set(self, value):
        with self._lock:
            self._value = value

    def set_max(self, value):
        """High-water-mark update."""
        with self._lock:
            if value > self._value:
                self._value = value
            return self._value

    def get(self):
        return self._value

    def reset(self):
        self.set(0)


# the default bucket bounds (callers pick the unit per histogram name)
_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


class Histogram:
    """Fixed-bucket histogram: counts per bucket (+inf last), sum, count.
    The bounds are frozen when it is registered."""

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Sequence[float]):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        with self._lock:
            self._sum += value
            self._count += 1
            self._counts[next((i for i, b in enumerate(self.buckets)
                               if value <= b), len(self.buckets))] += 1

    def snapshot(self) -> Dict[str, float]:
        """Cumulative `<name>_bucket_le_<bound>` counts, `<name>_sum` and
        `<name>_count`."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        out: Dict[str, float] = {}
        cum = 0
        for b, n in zip(self.buckets, counts[:-1]):
            cum += n
            out[f"{self.name}_bucket_le_{b:g}"] = cum
        out[f"{self.name}_bucket_le_inf"] = cum + counts[-1]
        out[f"{self.name}_sum"] = round(s, 6)
        out[f"{self.name}_count"] = c
        return out

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


_registry: Dict[str, Counter] = {}
_histograms: Dict[str, Histogram] = {}
_registry_lock = threading.Lock()


def register_counter(name: str, kind: str = "counter") -> Counter:
    """Register (or fetch) the counter `name`; asking for a gauge makes it
    one."""
    with _registry_lock:
        c = _registry.get(name)
        if c is None:
            c = _registry[name] = Counter(name, kind)
        elif kind == "gauge":
            c.kind = "gauge"
        return c


def counter(name: str) -> Counter:
    return register_counter(name)


def inc(name: str, delta=1):
    return register_counter(name).inc(delta)


def set_value(name: str, value):
    register_counter(name).set(value)


def set_gauge(name: str, value):
    """Set a value that goes up and down (queue depth, utilisation %),
    declared a `gauge` in `render_prometheus`."""
    register_counter(name, kind="gauge").set(value)


def set_max(name: str, value):
    return register_counter(name).set_max(value)


def histogram(name: str,
              buckets: Optional[Iterable[float]] = None) -> Histogram:
    """Fetch or register the histogram `name`. Its bounds are frozen on
    registration (`buckets`, or the default bounds); asking for other
    bounds later raises."""
    with _registry_lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = Histogram(
                name, tuple(buckets) if buckets else _DEFAULT_BUCKETS)
        elif buckets is not None and tuple(
                sorted(float(b) for b in buckets)) != h.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}; cannot re-register with {tuple(buckets)}")
        return h


def observe(name: str, value: float,
            buckets: Optional[Iterable[float]] = None):
    """Record one sample into the histogram `name`."""
    histogram(name, buckets).observe(value)


def get(name: str):
    c = _registry.get(name)
    return 0 if c is None else c.get()


def get_all() -> Dict[str, object]:
    with _registry_lock:
        items = sorted(_registry.items())
    return {k: c.get() for k, c in items}


def snapshot(prefix: Optional[str] = None,
             include_histograms: bool = True) -> Dict[str, object]:
    """Every counter and gauge whose name starts with `prefix` (all with
    None), and each such histogram flattened (unless
    `include_histograms=False`)."""
    with _registry_lock:
        counters = sorted(_registry.items())
        hists = sorted(_histograms.items()) if include_histograms else []
    out: Dict[str, object] = {}
    for k, c in counters:
        if prefix is None or k.startswith(prefix):
            out[k] = c.get()
    for k, h in hists:
        if prefix is None or k.startswith(prefix):
            out.update(h.snapshot())
    return out


_STEP_WALL_SPREAD_BUCKETS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                             5000.0)


def aggregate_mesh(prefix: Optional[str] = None,
                   snapshots: Optional[list] = None,
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


def render_prometheus(prefix: Optional[str] = None) -> str:
    """Prometheus text exposition (names sanitised to `[a-zA-Z0-9_]`,
    histogram buckets as `{le="..."}` labels)."""
    with _registry_lock:
        counters = sorted(_registry.items())
        hists = sorted(_histograms.items())

    def sane(name: str) -> str:
        return "".join(ch if ch.isalnum() or ch == "_" else "_"
                       for ch in name)

    lines = []
    for k, c in counters:
        if prefix is not None and not k.startswith(prefix):
            continue
        n = sane(k)
        lines.append(f"# TYPE {n} {c.kind}")
        lines.append(f"{n} {c.get()}")
    for k, h in hists:
        if prefix is not None and not k.startswith(prefix):
            continue
        n = sane(k)
        lines.append(f"# TYPE {n} histogram")
        snap = h.snapshot()
        for b in h.buckets:
            lines.append(f'{n}_bucket{{le="{b:g}"}} '
                         f"{snap[f'{k}_bucket_le_{b:g}']}")
        lines.append(f'{n}_bucket{{le="+Inf"}} '
                     f"{snap[f'{k}_bucket_le_inf']}")
        lines.append(f"{n}_sum {snap[f'{k}_sum']}")
        lines.append(f"{n}_count {snap[f'{k}_count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def reset(name: str):
    """Zero the one counter or histogram named `name`."""
    c = _registry.get(name)
    if c is not None:
        c.reset()
    h = _histograms.get(name)
    if h is not None:
        h.reset()


def reset_prefix(prefix: str):
    """Zero every counter and histogram whose name starts with `prefix`;
    they stay in `snapshot()` at 0."""
    with _registry_lock:
        counters = [c for k, c in _registry.items() if k.startswith(prefix)]
        hists = [h for k, h in _histograms.items() if k.startswith(prefix)]
    for c in counters:
        c.reset()
    for h in hists:
        h.reset()


def reset_all():
    reset_prefix("")
