"""Lazy eager mode: the port of `paddle_tpu/core/lazy.py`.

With lazy mode on (`set_lazy_mode(True)`, `lazy_guard()`, or
`FLAGS_lazy_mode`), `dispatch.apply` records each op into a pending
micro-graph (nodes: registered ops and their attrs; edges: tensor data
dependencies) and returns pending Tensors, whose `_data` is a
`LazyArray`. Its shape and dtype come from running the op on `meta`
tensors (the kernels' custom ops answer through their fake
implementations), so shape, dtype, device and ndim queries never run
anything; anything else read from it (a torch function, a method, an
operator, numpy) runs the pending graph and delegates to the value.

The pending graph is flushed at the barriers of the JAX package, counted
under the same reason names (`lazy.flushes.<reason>`):
- `value`: a value is observed (`numpy()`, `item()`, `print`, `bool`,
  `float`), or any code reads a pending Tensor's `_data` (the port's
  counterpart of JAX's `__jax_array__` rule: every module of the port
  reads `_data`, so each of them materialises what it reads);
- `backward`: `Tensor.backward()` / `paddle.grad` (`grad_cut` when
  `paddle.grad` asks for a pending intermediate: the region is cut there);
- `hook`: `register_hook` on a pending Tensor;
- `threshold`: `FLAGS_lazy_max_ops` recorded ops;
- `boundary`: a grad-requiring op consumes a product recorded under
  `no_grad` (the optimizer-update -> next-forward boundary: the product
  becomes a leaf of the next region, as in immediate mode);
- `disable`: lazy mode is switched off; `sync`: `core.sync()`.
A flush whose outputs are all dead (no Tensor holds them) runs nothing
(`lazy.flushes_dead`). The graph holds its leaf tensors alive, and a leaf
written in place before its region ran raises instead of giving another
value than the JAX package's frozen leaf.

How a flushed region runs:
- On the CPU it is replayed op by op under torch autograd: eager's values,
  and single, retained and double backward as eager has them.
- On the card it runs as a CUDA graph. The graph is keyed by the region's
  structure (`_region_sigs`, JAX's region registry, bounded by
  `_REGION_LIMIT`) and its leaves' shapes, dtypes and requires-grad
  masks; it is captured the second time a key is seen (the first run is
  a counted eager replay, `lazy.graph_first_sight`) and replayed after.
  A `backward` flush of a region whose seed outputs are all pending
  (`retain_graph` off) captures the forward AND the gradient of the seeds
  in one graph, the counterpart of JAX's fused backward
  (`lazy.fused_backward`); its leaf gradients then enter torch autograd
  at the leaves, so `.grad`, leaf hooks and earlier regions get them. A
  region with no gradient captures its forward. Parameters (leaves that
  require grad) are read in place, since the optimizers update them in
  place, and are part of the key by address; every other leaf is copied
  into the graph's static buffer, and the outputs are copied out, on each
  replay. Graphs share one memory pool and are bounded by `GRAPH_LIMIT`
  (least recently used first out) and with the region registry.
- A region that cannot be captured by rule (`capture_rule`) is replayed
  eagerly on the card and counted under `lazy.flush_fallbacks.<rule>`:
  `create_graph` (a graphed backward has no derivative), `grad_region`
  (a region on the tape flushed at another barrier than a fusable
  backward: its backward runs later, through torch autograd). An op that
  reads values on the host is never recorded (its meta-tensor run fails)
  and runs at once; an op function must not copy host data to the card
  (a capture raises on it), so the port's ops make such tensors outside
  their functions (dropout's key and scale). Every eager replay on the
  card adds to `lazy.uncaptured_replays`. There is no catch-all fallback: a capture or
  replay error raises.
Kernel launch counters stay exact under replay (`ops/kernels/_support.py`
`LaunchRecord`): a capture's launches are noted, and each replay adds
them. Dropout keys are tensor inputs of the op, so every replay draws a
new mask.
"""
from __future__ import annotations

import collections
import itertools
import math
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from ..framework import flags, monitor
from ..framework.dtype import is_inexact

__all__ = ["LazyArray", "is_lazy_enabled", "set_lazy_mode", "lazy_guard",
           "sync", "pending_ops", "is_pending", "capture_rule",
           "clear_graphs", "graph_bytes"]

NOT_HANDLED = object()

_state = threading.local()
# set once any thread turns lazy mode on: `dispatch.apply` reads it first,
# so with lazy mode never on the eager path pays one global read
_ACTIVE = bool(flags.flag_value("lazy_mode"))

# region structure signature -> region name, FIFO-bounded
_region_sigs: "collections.OrderedDict[tuple, str]" = \
    collections.OrderedDict()
_region_counter = itertools.count()
_REGION_LIMIT = 1024

# (op, attr key, input shapes and dtypes) -> (((shape, dtype), ...), tuple?)
_aval_cache: Dict[tuple, tuple] = {}
_AVAL_CACHE_LIMIT = 8192

# the card's captured regions: key -> _RegionGraph, least recent first
_graphs: "collections.OrderedDict[tuple, _RegionGraph]" = \
    collections.OrderedDict()
GRAPH_LIMIT = 16
# a key is captured the time it is seen this often
CAPTURE_AT_SIGHTING = 2
_sightings: "collections.OrderedDict[tuple, int]" = collections.OrderedDict()
_pool = None
_capture_lock = threading.Lock()

def _activate(on=True):
    global _ACTIVE
    if on:
        _ACTIVE = True


flags.watch_flag("lazy_mode", _activate)


def is_lazy_enabled() -> bool:
    v = getattr(_state, "enabled", None)
    if v is None:
        v = bool(flags.flag_value("lazy_mode"))
        _state.enabled = v
    return v


def set_lazy_mode(enable: bool) -> bool:
    """Switch lazy eager mode for this thread; returns the previous value.
    Disabling flushes any pending ops (no recorded work is lost)."""
    prev = is_lazy_enabled()
    _state.enabled = bool(enable)
    _activate(bool(enable))
    if prev and not enable:
        sync(reason="disable")
    return prev


class lazy_guard:
    """Context manager scoping lazy mode: ``with lazy_guard(): ...``."""

    def __init__(self, enable: bool = True):
        self._enable = enable
        self._prev = None

    def __enter__(self):
        self._prev = set_lazy_mode(self._enable)
        return self

    def __exit__(self, *exc):
        set_lazy_mode(self._prev)
        return False


def _graph() -> "LazyGraph":
    g = getattr(_state, "graph", None)
    if g is None:
        g = _state.graph = LazyGraph()
    return g


def sync(reason: str = "sync"):
    """Flush any pending lazy ops (a materialisation barrier); exposed as
    `paddle_tpu_torch.core.sync()`. Nothing happens when nothing is
    pending."""
    g = getattr(_state, "graph", None)
    if g is not None and g.nodes:
        g.flush(reason)


def pending_ops() -> int:
    """The ops recorded and not flushed yet."""
    g = getattr(_state, "graph", None)
    return 0 if g is None else len(g.nodes)


def is_pending(t) -> bool:
    """Whether Tensor `t` is the output of a recorded op not run yet."""
    d = t._data
    return type(d) is LazyArray and d._concrete is None


def _pending_of(t):
    """The LazyArray of pending Tensor `t` (an alias's primary), else
    None."""
    d = t._data
    if type(d) is LazyArray and d._concrete is None:
        return _root(d)
    return None


def sync_backward(tensors, grad_tensors, retain_graph):
    """The barrier of `backward()`. When every pending seed output belongs
    to the current graph and the graph is not retained, the flush runs the
    forward and the seeds' gradient together; returns the ids of the
    seeds whose backward that flush already ran (on the card), which
    `run_backward` must not run again."""
    from .tensor import Tensor

    for gt in grad_tensors:
        if isinstance(gt, Tensor) and _pending_of(gt) is not None:
            materialize(gt)     # a pending seed cotangent
    g = getattr(_state, "graph", None)
    if g is None or not g.nodes:
        return ()
    seeds = []
    ok = not retain_graph
    if ok:
        for t, gt in zip(tensors, grad_tensors):
            lz = _pending_of(t)
            if lz is not None:
                if lz._graph is not g:
                    ok = False
                    break
                seeds.append((t, lz, gt))
    if ok and seeds:
        return g.flush("backward", seeds=seeds)
    g.flush("backward")
    return ()


def sync_for_grad(outputs, inputs, create_graph=False):
    """The barrier of `paddle.grad`: a requested input that is a pending
    intermediate becomes a region boundary (a partial flush), so its
    gradient surfaces between regions."""
    while True:
        g = getattr(_state, "graph", None)
        if g is None or not g.nodes:
            return
        pend = [_pending_of(t) for t in inputs if t is not None]
        cuts = [lz._node for lz in pend if lz is not None and lz._graph is g]
        if not cuts:
            g.flush("backward", create_graph=create_graph)
            return
        g.flush_upto(min(cuts) + 1, "grad_cut", create_graph)


# ---------------------------------------------------------------------------
# the pending value
# ---------------------------------------------------------------------------


class LazyArray:
    """A value not computed yet, in a pending Tensor's `_data`. Its shape,
    dtype, device and requires_grad (and `ndim`, `dim()`, `numel()`) are
    known now;
    anything else (a torch function given it, a method, an operator,
    `numpy`) flushes its graph and delegates to the value, which the flush
    also swaps into every Tensor that holds it. A detached Tensor over a
    pending value holds an alias: the same output, detached."""

    __slots__ = ("_graph", "_node", "_out", "shape", "dtype", "device",
                 "requires_grad", "_concrete", "_owners", "_primary",
                 "_aliases", "__weakref__")

    def __init__(self, graph, node_idx, out_idx, shape, dtype, device,
                 requires_grad=False, primary=None):
        self._graph = graph
        self._node = node_idx
        self._out = out_idx
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = device
        self.requires_grad = requires_grad
        self._concrete = None
        self._owners = weakref.WeakSet()
        # an alias holds its primary alive (the output stays live for
        # it); a primary holds None, not itself: no reference cycle
        self._primary = primary
        self._aliases = weakref.WeakSet()

    # -- metadata: never flushes ---------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    # -- the value ------------------------------------------------------------
    def materialize(self) -> torch.Tensor:
        if self._concrete is None:
            p = _root(self)
            p._graph.flush("value")
            if self._concrete is None:
                raise RuntimeError("lazy value was lost: its graph flushed "
                                   "without producing this output")
        return self._concrete

    def new_owner(self, stop_gradient: bool):
        """A detached Tensor over this value (`detach()`)."""
        p = _root(self)
        alias = LazyArray(p._graph, p._node, p._out, p.shape, p.dtype,
                          p.device, False, primary=p)
        p._aliases.add(alias)
        return _pending_tensor(alias, stop_gradient)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        args, kwargs = _materialized((args, kwargs or {}))
        return func(*args, **kwargs)

    def __getattr__(self, name):
        # anything beyond the metadata is a value observation
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.materialize(), name)

    def __array__(self, dtype=None, copy=None):
        a = self.materialize().detach().cpu().numpy()
        return a.astype(dtype) if dtype is not None else a

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of a 0-d tensor")
        return self.shape[0]

    def __bool__(self):
        return bool(self.materialize())

    def __int__(self):
        return int(self.materialize())

    def __float__(self):
        return float(self.materialize())

    def __index__(self):
        return self.materialize().__index__()

    def __getitem__(self, idx):
        return self.materialize()[idx]

    def __iter__(self):
        return iter(self.materialize())

    def __repr__(self):
        state = "materialized" if self._concrete is not None else "pending"
        return (f"LazyArray(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"{state})")

    def _delegate(name):  # noqa: N805
        def op(self, *other):
            return getattr(self.materialize(), name)(*other)

        op.__name__ = name
        return op

    for _n in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
               "__rmul__", "__truediv__", "__rtruediv__", "__matmul__",
               "__rmatmul__", "__pow__", "__rpow__", "__neg__", "__lt__",
               "__le__", "__gt__", "__ge__", "__and__", "__or__",
               "__invert__"):
        locals()[_n] = _delegate(_n)
    del _n, _delegate


def _root(laz: LazyArray) -> LazyArray:
    """An alias's primary, else `laz` itself."""
    return laz if laz._primary is None else laz._primary


def _materialized(obj):
    """`obj` (args / kwargs, nested in lists, tuples and dicts) with every
    LazyArray replaced by its value."""
    if type(obj) is LazyArray:
        return obj.materialize()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_materialized(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _materialized(v) for k, v in obj.items()}
    return obj


def materialize(t) -> torch.Tensor:
    """The value of Tensor `t`, flushing its pending graph if needed (with
    `t`'s own stop_gradient)."""
    d = t._data
    if type(d) is LazyArray:
        d.materialize()
        if t._data is d:
            _give(t, d._concrete)
        return t._data
    return d


def _pending_tensor(laz: LazyArray, stop_gradient: bool):
    from .tensor import Tensor, _name_counter

    t = Tensor.__new__(Tensor)
    t._data = laz
    t._sg = bool(stop_gradient)
    t._grad_wrap = None
    t.name = f"tensor_{next(_name_counter)}"
    t.persistable = False
    laz._owners.add(t)
    return t


def _give(t, concrete: torch.Tensor):
    """Make pending Tensor `t` concrete, keeping its stop_gradient."""
    want = t._sg
    t._data = concrete
    t._sg = True
    if t.stop_gradient != want:
        t.stop_gradient = want


# ---------------------------------------------------------------------------
# the pending micro-graph
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = ("op_name", "fn", "attrs", "in_refs", "slot_masks",
                 "requires", "multi", "out_meta", "out_sg", "out_refs",
                 "owner_refs", "_sig")

    def __init__(self, op_name, fn, attrs, in_refs, slot_masks, requires,
                 multi, out_meta, out_sg):
        self.op_name = op_name
        self.fn = fn
        self.attrs = attrs
        # in_refs[i]: ("l", leaf) | ("n", node, out) | ("c",) (None)
        self.in_refs = in_refs
        self.slot_masks = slot_masks
        self.requires = requires
        self.multi = multi
        self.out_meta = out_meta        # ((shape, dtype, device), ...)
        self.out_sg = out_sg            # stop_gradient per output
        self.out_refs: List = []        # weakrefs to LazyArrays
        self.owner_refs: List = []      # weakrefs to the first owners


class _Leaf:
    __slots__ = ("value", "mask", "version")

    def __init__(self, value: torch.Tensor, mask: bool):
        self.value = value              # held alive by the graph
        self.mask = mask                # carries gradient into the region
        self.version = value._version


def _bound(v: torch.Tensor) -> bool:
    """A leaf the card's graph reads in place: a tensor that is a leaf of
    autograd and requires grad (a parameter)."""
    return v.requires_grad and v.grad_fn is None


class LazyGraph:
    def __init__(self):
        self.nodes: List[_Node] = []
        self.leaves: List[_Leaf] = []
        self._leaf_by_id: Dict[int, int] = {}
        self.requires_any = False
        self._flushed = False

    def _add_leaf(self, value: torch.Tensor, mask: bool) -> int:
        # one leaf per tensor object: two Tensors over one buffer hold two
        # torch tensors, each with its own gradient
        idx = self._leaf_by_id.get(id(value))
        if idx is None:
            idx = len(self.leaves)
            self.leaves.append(_Leaf(value, mask))
            self._leaf_by_id[id(value)] = idx
        return idx

    # -- flush --------------------------------------------------------------
    def flush(self, reason: str, seeds=None, create_graph=False):
        """Run the whole pending graph as one region; returns the ids of
        the seed Tensors whose backward the flush ran."""
        if self._flushed or not self.nodes:
            return ()
        self._flushed = True
        if getattr(_state, "graph", None) is self:
            _state.graph = LazyGraph()  # records during the flush start anew

        live = []
        for i, node in enumerate(self.nodes):
            for j, ref in enumerate(node.out_refs):
                laz = ref()
                if laz is not None and laz._concrete is None:
                    live.append((i, j))
        n_ops = len(self.nodes)
        monitor.inc("lazy.flushes")
        monitor.inc(f"lazy.flushes.{reason}")
        monitor.inc("lazy.fused_ops", n_ops)
        monitor.set_max("lazy.max_region_ops", n_ops)
        if not live:
            # nothing the program can ever observe: drop the region
            monitor.inc("lazy.flushes_dead")
            return ()
        for lf in self.leaves:
            if lf.value._version != lf.version:
                raise RuntimeError(
                    "a leaf of a pending lazy region was written in place "
                    "before the region ran; call "
                    "paddle_tpu_torch.core.sync() before writing it")
        name = self._region_name(live)
        fused = seeds is not None and self._fusable(seeds)
        if fused:
            monitor.inc("lazy.fused_backward")
        outs, consumed = self._execute(name, live, seeds if fused else None,
                                       create_graph)
        out_tensors = self._distribute(live, outs)
        from . import dispatch

        dispatch._check_outputs(name, out_tensors)
        return consumed

    def flush_upto(self, k: int, reason: str, create_graph=False):
        """Partial flush: run nodes[:k] and keep the rest pending as a new
        graph, whose references to the flushed outputs become leaves. Lets
        `paddle.grad(y, x)` cut the region at an intermediate `x`."""
        if self._flushed or not self.nodes:
            return
        if k >= len(self.nodes):
            self.flush(reason, create_graph=create_graph)
            return
        tail = self.nodes[k:]
        self.nodes = self.nodes[:k]
        # keep the head outputs the tail reads alive through the flush
        ref_map = {}
        for nd in tail:
            for ref in nd.in_refs:
                if ref[0] == "n" and ref[1] < k \
                        and (ref[1], ref[2]) not in ref_map:
                    i, j = ref[1], ref[2]
                    laz = self.nodes[i].out_refs[j]()
                    if laz is None:
                        shape, dt, dev = self.nodes[i].out_meta[j]
                        laz = LazyArray(self, i, j, shape, dt, dev,
                                        not self.nodes[i].out_sg[j])
                        self.nodes[i].out_refs[j] = weakref.ref(laz)
                    ref_map[(i, j)] = laz
        self.flush(reason, create_graph=create_graph)

        interim = getattr(_state, "graph", None)
        new = LazyGraph()
        leaf_map: Dict[int, int] = {}

        def remap(ref):
            if ref[0] == "l":
                ni = leaf_map.get(ref[1])
                if ni is None:
                    lf = self.leaves[ref[1]]
                    ni = leaf_map[ref[1]] = len(new.leaves)
                    new.leaves.append(lf)
                    new._leaf_by_id[id(lf.value)] = ni
                return ("l", ni)
            if ref[0] == "n":
                if ref[1] >= k:
                    return ("n", ref[1] - k, ref[2])
                val = ref_map[(ref[1], ref[2])]._concrete
                return ("l", new._add_leaf(
                    val, val.requires_grad and is_inexact(val.dtype)))
            return ref

        for nd in tail:
            nd.in_refs = tuple(remap(r) for r in nd.in_refs)
            nd._sig = (nd.op_name, nd._sig[1], nd.in_refs, nd.slot_masks,
                       nd.requires, nd.multi, len(nd.out_meta))
            new.nodes.append(nd)
            new.requires_any = new.requires_any or nd.requires
            for ref in nd.out_refs:
                laz = ref()
                if laz is not None:
                    laz._graph = new
                    laz._node -= k
        if interim is not None and interim.nodes:
            interim.flush(reason)   # ops recorded by observers mid-flush
        _state.graph = new

    def _fusable(self, seeds) -> bool:
        if not (self.requires_any and any(lf.mask for lf in self.leaves)):
            return False
        for _t, laz, _gt in seeds:
            nd = self.nodes[laz._node]
            if nd.out_sg[laz._out] or not is_inexact(laz.dtype):
                return False
        return True

    def _signature(self, live) -> tuple:
        return (tuple(nd._sig for nd in self.nodes), tuple(live),
                len(self.leaves))

    def _region_name(self, live) -> str:
        sig = self._signature(live)
        name = _region_sigs.get(sig)
        if name is None:
            while len(_region_sigs) >= _REGION_LIMIT:
                _evict_region(_region_sigs.popitem(last=False)[1])
            name = f"__lazy_region_{next(_region_counter)}"
            _region_sigs[sig] = name
        return name

    def _device(self) -> Optional[torch.device]:
        for lf in self.leaves:
            return lf.value.device
        return None

    def _execute(self, name, live, seeds, create_graph):
        values = [lf.value for lf in self.leaves]
        dev = self._device()
        if dev is None or dev.type != "cuda":
            return _replay(self.nodes, values, live), ()
        masked = [lf.mask for lf in self.leaves]
        rule = capture_rule(requires=self.requires_any and any(masked),
                            fused=seeds is not None,
                            create_graph=create_graph)
        if rule is not None:
            monitor.inc("lazy.uncaptured_replays")
            monitor.inc("lazy.flush_fallbacks")
            monitor.inc(f"lazy.flush_fallbacks.{rule}")
            return _replay(self.nodes, values, live), ()
        seed_grads = None
        seed_key = None
        if seeds is not None:
            seed_grads = [None if gt is None else _seed_value(gt, laz)
                          for _t, laz, gt in seeds]
            seed_key = tuple((live.index((laz._node, laz._out)), gt is None)
                             for _t, laz, gt in seeds)
        key = (name, seed_key) + tuple(_leaf_key(lf) for lf in self.leaves)
        with _capture_lock:
            rg = _graphs.get(key)
            if rg is None:
                seen = _sightings.pop(key, 0) + 1
                if seen < CAPTURE_AT_SIGHTING:
                    _sightings[key] = seen
                    while len(_sightings) > 4 * _REGION_LIMIT:
                        _sightings.popitem(last=False)
                    monitor.inc("lazy.uncaptured_replays")
                    monitor.inc("lazy.graph_first_sight")
                    return _replay(self.nodes, values, live), ()
                rg = _RegionGraph.capture(self, live, seeds, seed_grads)
                _graphs[key] = rg
                monitor.inc("lazy.graph_captures")
                while len(_graphs) > GRAPH_LIMIT:
                    _graphs.popitem(last=False)
                    monitor.inc("lazy.graph_evictions")
            else:
                _graphs.move_to_end(key)
        outs = rg.run(values, seed_grads)
        consumed = tuple(id(t) for t, _laz, _gt in seeds) \
            if seeds is not None else ()
        return outs, consumed

    def _distribute(self, live, outs):
        """Give every owning Tensor its value; returns the first owners."""
        out_tensors = []
        for k, (i, j) in enumerate(live):
            nd = self.nodes[i]
            laz = nd.out_refs[j]()
            if laz is None:
                continue
            laz._concrete = outs[k]
            for a in [laz, *laz._aliases]:
                if a is not laz:
                    a._concrete = outs[k].detach()
                a._graph = None     # the flushed graph (and its leaves) can go
                for t in list(a._owners):
                    if t._data is a:
                        _give(t, a._concrete)
            owner = nd.owner_refs[j]()
            if owner is not None:
                out_tensors.append(owner)
        return out_tensors


def _seed_value(gt, laz) -> torch.Tensor:
    from .tensor import Tensor

    g = gt._data if isinstance(gt, Tensor) else torch.as_tensor(gt)
    return g.to(device=laz.device, dtype=laz.dtype)


def _leaf_key(lf: _Leaf) -> tuple:
    v = lf.value
    if _bound(v):
        return (tuple(v.shape), v.dtype, lf.mask, v.device, v.data_ptr(),
                v.stride())
    return (tuple(v.shape), v.dtype, lf.mask)


def _evict_region(name: str):
    for key in [k for k in _graphs if k[0] == name]:
        del _graphs[key]
        monitor.inc("lazy.graph_evictions")
    for key in [k for k in _sightings if k[0] == name]:
        del _sightings[key]


def capture_rule(requires: bool, fused: bool,
                 create_graph: bool = False) -> Optional[str]:
    """Why a region cannot run as a CUDA graph, or None when it can:
    `create_graph` (its gradient must be differentiable, and a graphed
    backward is not) and `grad_region` (it carries gradient but is not
    flushed by a fusable backward, so its backward runs later through
    torch autograd). An op that reads values on the host never enters a
    region: its shapes cannot be found on meta tensors, so it runs
    immediately (`lazy.record_fallbacks`)."""
    if create_graph:
        return "create_graph"
    if requires and not fused:
        return "grad_region"
    return None


def _replay(nodes, leaf_values, live):
    """Run the recorded ops on `leaf_values` under torch autograd, as
    immediate mode runs them: a node recorded without gradient runs under
    `no_grad`, and a slot that stops gradient gets a detached input."""
    vals: List[list] = []
    for nd in nodes:
        args = []
        for ref, m in zip(nd.in_refs, nd.slot_masks):
            if ref[0] == "l":
                v = leaf_values[ref[1]]
            elif ref[0] == "n":
                v = vals[ref[1]][ref[2]]
            else:
                v = None
            if nd.requires and not m and v is not None and v.requires_grad:
                v = v.detach()
            args.append(v)
        with torch.set_grad_enabled(nd.requires):
            out = nd.fn(*args, **nd.attrs)
        vals.append(list(out) if nd.multi else [out])
    return [vals[i][j] for i, j in live]


# ---------------------------------------------------------------------------
# the card: a region as a CUDA graph
# ---------------------------------------------------------------------------


class _Spent(torch.autograd.Function):
    """The tape of an output whose region already ran its backward in the
    graph (one-shot, as JAX's fused backward node): a second backward
    raises as torch's does."""

    @staticmethod
    def forward(ctx, x, anchor):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "Trying to backward through the graph a second time: this lazy "
            "region ran its backward when it was flushed. Specify "
            "retain_graph=True the first time.")


def _anchor(device):
    return torch.zeros((), device=device, requires_grad=True)


def _pool_handle():
    global _pool
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    return _pool


class _RegionGraph:
    """One region captured as a CUDA graph: the static leaves (parameters
    in place, copies of the rest), the static outputs, and for a backward
    flush the seeds' cotangent buffers and the leaves' gradients."""

    def __init__(self, graph, launches, static, copy_slots, outs, out_sg,
                 seed_bufs, grad_slots, grads):
        self.graph = graph
        self.launches = launches
        self.static = static
        self.copy_slots = copy_slots
        self.outs = outs
        self.out_sg = out_sg
        self.seed_bufs = seed_bufs
        self.grad_slots = grad_slots
        self.grads = grads

    @classmethod
    def capture(cls, lg: LazyGraph, live, seeds, seed_grads):
        from ..ops.kernels import _support

        static, copy_slots = [], []
        for i, lf in enumerate(lg.leaves):
            v = lf.value
            if _bound(v):
                # the same memory under a fresh autograd leaf: the capture
                # uses none of the parameter's own autograd state (its
                # gradient accumulator may belong to a graph a caller
                # still holds, on another stream; its hooks run once, in
                # the backward after each replay)
                static.append(v.detach().requires_grad_())
            else:
                buf = torch.empty_like(
                    v, memory_format=torch.contiguous_format)
                buf.copy_(v.detach())
                if seeds is not None and lf.mask:
                    buf.requires_grad_(True)
                static.append(buf)
                copy_slots.append(i)
        seed_slots, seed_bufs, grad_slots = [], [], []
        if seeds is not None:
            for (_t, laz, _gt), g in zip(seeds, seed_grads):
                seed_slots.append(live.index((laz._node, laz._out)))
                seed_bufs.append(
                    torch.ones(laz.shape, dtype=laz.dtype, device=laz.device)
                    if g is None else g.detach().clone())
            grad_slots = [i for i, lf in enumerate(lg.leaves) if lf.mask]

        def body():
            outs = _replay(lg.nodes, static, live)
            if seeds is None:
                return outs, None
            grads = torch.autograd.grad(
                [outs[k] for k in seed_slots],
                [static[i] for i in grad_slots], grad_outputs=seed_bufs,
                allow_unused=True)
            return [o.detach() for o in outs], grads

        # a warm-up on a side stream (libraries' lazy set-up happens
        # outside the capture), its launches not counted
        torch.cuda.synchronize()
        with torch.cuda.stream(torch.cuda.Stream()), \
                _support.launches_discarded():
            body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        launches = _support.LaunchRecord()
        with launches.recording(), torch.cuda.graph(graph,
                                                    pool=_pool_handle()):
            outs, grads = body()
        out_sg = [lg.nodes[i].out_sg[j] for i, j in live]
        return cls(graph, launches, static, copy_slots, outs, out_sg,
                   seed_bufs, grad_slots, grads)

    def replay(self):
        self.graph.replay()
        self.launches.replayed()
        monitor.inc("lazy.graph_replays")

    def run(self, values, seed_grads):
        with torch.no_grad():
            for i in self.copy_slots:
                self.static[i].copy_(values[i])
            for buf, g in zip(self.seed_bufs, seed_grads or ()):
                if g is not None:
                    buf.copy_(g)
        self.replay()
        outs = [o.clone() for o in self.outs]
        if self.grads is None:
            return outs
        pairs = [(values[i], g) for i, g in zip(self.grad_slots, self.grads)
                 if g is not None]
        if pairs:
            torch.autograd.backward([v for v, _ in pairs],
                                    [g for _, g in pairs])
        anchor = None
        for k, o in enumerate(outs):
            if not self.out_sg[k] and is_inexact(o.dtype):
                anchor = anchor if anchor is not None else _anchor(o.device)
                outs[k] = _Spent.apply(o, anchor)
        return outs

    def nbytes(self) -> int:
        """The bytes the graph's static tensors hold (its pool's
        intermediates not included)."""
        ts = [self.static[i] for i in self.copy_slots] + list(self.outs) \
            + list(self.seed_bufs) \
            + [g for g in self.grads or () if g is not None]
        return sum(t.numel() * t.element_size() for t in ts)


def clear_graphs():
    """Drop every captured graph and sighting (their memory returns to the
    pool, and the pool to the card once no graph holds it)."""
    global _pool
    with _capture_lock:
        _graphs.clear()
        _sightings.clear()
        _pool = None


def graph_bytes() -> List[int]:
    """The static bytes each captured graph holds, least recently used
    first."""
    return [g.nbytes() for g in _graphs.values()]


# ---------------------------------------------------------------------------
# recording (from dispatch.apply when lazy mode is on)
# ---------------------------------------------------------------------------


def _attr_key(attrs):
    if not attrs:
        return ()
    return tuple(sorted(attrs.items()))


# ops that always run now: the sparse embedding's backward writes a
# SelectedRows beside its weight, outside any region's tape (JAX's lazy
# mode records the lookup but keeps its grad node its own)
_EAGER_OPS = frozenset({"embedding_sparse"})


def try_record(op, tensor_inputs, attrs):
    """Record one op into the pending graph; returns its pending output
    Tensor(s), or NOT_HANDLED when the op must run now (an op of
    `_EAGER_OPS`, an input that is not a tensor, unhashable attrs, or an
    op whose shapes cannot be found without running it)."""
    from .tensor import Tensor

    if op.name in _EAGER_OPS:
        return NOT_HANDLED
    graph = _graph()

    # pass 1: classify the inputs (no graph mutation yet)
    infos = []  # (value: torch.Tensor | LazyArray | None, mask)
    any_mask = False
    for t in tensor_inputs:
        if isinstance(t, Tensor):
            v = t._data
            if type(v) is LazyArray:
                p = _root(v)
                if v._concrete is not None or p._graph is not graph:
                    v = materialize(t)
                else:
                    v = p
            m = not t.stop_gradient and is_inexact(v.dtype)
        elif isinstance(t, torch.Tensor):
            v, m = t, t.requires_grad and is_inexact(t.dtype)
        elif t is None:
            v, m = None, False
        else:
            return NOT_HANDLED
        any_mask = any_mask or m
        infos.append((v, m))

    requires = any_mask and torch.is_grad_enabled()
    if requires:
        for v, m in infos:
            if m and type(v) is LazyArray and \
                    graph.nodes[v._node].out_sg[v._out]:
                # a grad-requiring slot consuming a product recorded
                # without gradient: flush it, so it becomes a leaf of the
                # next region (mask-False consumers keep fusing)
                graph.flush("boundary")
                return try_record(op, tensor_inputs, attrs)

    try:
        akey = _attr_key(attrs)
        in_meta = tuple(None if v is None else (tuple(v.shape), v.dtype)
                        for v, _ in infos)
        ckey = (op.name, akey, in_meta)
        entry = _aval_cache.get(ckey)
    except TypeError:           # an unhashable attr
        monitor.inc("lazy.record_fallbacks")
        return NOT_HANDLED
    if entry is None:
        try:
            entry = _infer_meta(op, attrs, in_meta)
        except Exception:
            monitor.inc("lazy.record_fallbacks")
            return NOT_HANDLED
        if len(_aval_cache) >= _AVAL_CACHE_LIMIT:
            _aval_cache.pop(next(iter(_aval_cache)))
        _aval_cache[ckey] = entry
    out_meta, is_tuple = entry
    device = next((v.device for v, _ in infos if v is not None), None)
    if device is None:          # no tensor input: nothing to defer
        return NOT_HANDLED

    # pass 2: mutate the graph
    in_refs, slot_masks = [], []
    for v, m in infos:
        if v is None:
            in_refs.append(("c",))
        elif type(v) is LazyArray:
            in_refs.append(("n", v._node, v._out))
        else:
            in_refs.append(("l", graph._add_leaf(v, m)))
        slot_masks.append(m)
    out_sg = tuple(not (requires and is_inexact(dt)) for _s, dt in out_meta)
    node_idx = len(graph.nodes)
    node = _Node(op.name, op.fn, dict(attrs), tuple(in_refs),
                 tuple(slot_masks), requires, is_tuple,
                 tuple((s, dt, device) for s, dt in out_meta), out_sg)
    node._sig = (op.name, akey, node.in_refs, node.slot_masks, requires,
                 is_tuple, len(out_meta))
    graph.nodes.append(node)
    graph.requires_any = graph.requires_any or requires

    results = []
    for i, (shape, dt) in enumerate(out_meta):
        laz = LazyArray(graph, node_idx, i, shape, dt, device, not out_sg[i])
        t = _pending_tensor(laz, out_sg[i])
        node.out_refs.append(weakref.ref(laz))
        node.owner_refs.append(weakref.ref(t))
        results.append(t)

    if len(graph.nodes) >= flags.flag_value("lazy_max_ops"):
        graph.flush("threshold")
    return results if is_tuple else results[0]


def _infer_meta(op, attrs, in_meta):
    """The op's output shapes and dtypes, from running it on meta
    tensors."""
    args = [None if m is None else torch.empty(m[0], dtype=m[1],
                                               device="meta")
            for m in in_meta]
    with torch.no_grad():
        out = op.fn(*args, **attrs)
    is_tuple = isinstance(out, (tuple, list))
    outs = tuple(out) if is_tuple else (out,)
    return tuple((tuple(o.shape), o.dtype) for o in outs), is_tuple
