"""Eager collectives of the single-controller world (the port of
`paddle_tpu/distributed/communication/collective.py`).

API parity with `python/paddle/distributed/communication/` (all_reduce,
all_gather, broadcast, reduce, scatter, reduce_scatter, alltoall,
send / recv, barrier and the `*_object` forms).

Single-controller convention, as in the JAX package: a tensor taking
part in an eager collective is the *stack of per-rank values*, shape
`[nranks, ...local]`: one marked stacked by a collective, or a
DistTensor whose dim 0 is split over the mesh (or partial). A plain
tensor means "every rank holds this same value" and is broadcast to the
stack. Every reduction over the stacked axis runs in rank order
(`sharding_bridge.reduce_stacked`), so one world gives the same bits on
every run and on every device.

The multi-process convention (launch-spawned workers, one process a
rank) is the next distributed slice's, over `torch.distributed`: under
an initialised `torch.distributed` world of more than one process every
collective raises `MultiProcessNotPorted` rather than compute from
local data alone. The comm trace of `observability/comms.py` (kind,
group, bytes, wall) is not ported either; it hooks in at
`_run_compiled`.
"""
from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np
import torch

from ...core import lazy
from ...core.tensor import Tensor
from ..auto_parallel import sharding_bridge as sb
from .group import Group, _get_global_group

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_object",
           "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
           "scatter", "scatter_object_list", "alltoall", "alltoall_single",
           "send", "recv", "isend", "irecv", "gather", "barrier",
           "P2POp", "batch_isend_irecv", "wait", "MultiProcessNotPorted"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class MultiProcessNotPorted(NotImplementedError):
    """A collective under a `torch.distributed` world of more than one
    process: the multi-process convention (the JAX package's
    `_multiproc` branch, `communication/p2p.py`, `launch/`) is the next
    distributed slice of the port."""

    def __init__(self, what: str):
        super().__init__(
            f"{what} under a multi-process world: the multi-process "
            "convention (torch.distributed ranks, p2p, launch) is not "
            "ported yet; it is the next distributed slice")


def _group(group) -> Group:
    return group if group is not None else _get_global_group()


def _multiproc() -> bool:
    """True under a live `torch.distributed` world of several processes."""
    import torch.distributed as tdist

    return tdist.is_available() and tdist.is_initialized() \
        and tdist.get_world_size() > 1


def _refuse_multiproc(kind: str) -> None:
    if _multiproc():
        raise MultiProcessNotPorted(f"collective '{kind}'")


def _value(t) -> torch.Tensor:
    """The torch value of a Tensor (a pending lazy value flushed first:
    a collective is a value barrier of lazy mode) or of an array."""
    if isinstance(t, Tensor):
        return lazy.materialize(t).detach()
    return torch.as_tensor(np.asarray(t))


def _is_stacked(t: Tensor) -> bool:
    """A tensor is rank-stacked when a collective marked it, or when its
    dim 0 is split over the mesh (a Shard(0) or a Partial's hidden
    axis)."""
    if t.__dict__.get("_rank_stacked", False):
        return True
    meta = sb.meta_of(t)
    if meta is None:
        return False
    if meta.partial_dims:
        return True
    return any(p.is_shard() and p.get_dim() in (0, -t.ndim)
               for p in meta.placements)


def _mark_stacked(t: Tensor) -> Tensor:
    t.__dict__["_rank_stacked"] = True
    return t


def _as_stack(t: Tensor, g: Group):
    """[nranks, ...] stacked view of the tensor's per-rank values."""
    arr = _value(t)
    if arr.dim() >= 1 and arr.shape[0] == g.nranks and _is_stacked(t):
        return arr, True
    return arr[None].expand((g.nranks,) + tuple(arr.shape)), False


def _program(kind: str, g: Group, extra):
    """One collective over the [nranks, ...] stack."""
    n = g.nranks
    if kind == "all_reduce":
        return lambda x: sb.reduce_stacked(x, extra)[None].expand(
            x.shape).contiguous()
    if kind == "reduce":
        red, dst = extra

        def fn(x):
            out = x.clone()
            out[dst] = sb.reduce_stacked(x, red)
            return out
        return fn
    if kind == "broadcast":
        return lambda x: x[extra][None].expand(x.shape).contiguous()
    if kind == "reduce_scatter":
        def fn(x):
            # x: [n, n*chunk, ...] per-rank inputs; out[r] = sum_r' x[r', r]
            r = sb.reduce_stacked(x, extra)
            return r.reshape((n, -1) + tuple(r.shape[1:])) if r.dim() >= 1 \
                else r
        return fn
    if kind == "alltoall":
        def fn(x):
            # x: [n, n*chunk, ...]; out[r] = concat_r'(x[r', r-th chunk])
            chunks = x.reshape((n, n, -1) + tuple(x.shape[2:]))
            return chunks.transpose(0, 1).reshape(x.shape).contiguous()
        return fn
    if kind == "shift":  # ring p2p: out[r] = x[(r - offset) % n]
        return lambda x: torch.roll(x, extra, 0)
    raise ValueError(kind)  # pragma: no cover


def _run_compiled(kind: str, g: Group, fn, stacked):
    """Run one collective over the stack: the one funnel every
    collective program passes, where the JAX package records its comm
    trace behind the one-bool observability gate."""
    return fn(stacked)


def _run(kind, t: Tensor, group, extra=None, in_place=True):
    _refuse_multiproc(kind)
    g = _group(group)
    stacked, was_stacked = _as_stack(t, g)
    out = _run_compiled(kind, g, _program(kind, g, extra), stacked)
    if in_place:
        t._data = out if was_stacked else out[0].clone()
        if was_stacked:
            _mark_stacked(t)
        return t
    res = Tensor(out if was_stacked else out[0], stop_gradient=True)
    if was_stacked:
        _mark_stacked(res)
    return res


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def all_reduce(tensor: Tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place all-reduce (reference `dist.all_reduce`)."""
    return _FinishedTask(_run("all_reduce", tensor, group, extra=op))


def reduce(tensor: Tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    g = _group(group)
    local = g.get_group_rank(dst)
    return _FinishedTask(_run("reduce", tensor, group,
                              extra=(op, local if local >= 0 else dst)))


def broadcast(tensor: Tensor, src=0, group=None, sync_op=True):
    """Broadcast the stacked rank `src`'s value (reference
    `dist.broadcast`)."""
    g = _group(group)
    src_local = g.get_group_rank(src)
    return _FinishedTask(_run("broadcast", tensor, group,
                              extra=src_local if src_local >= 0 else src))


def all_gather(tensor_list: Optional[List[Tensor]], tensor: Tensor,
               group=None, sync_op=True):
    """Gather per-rank values; fills `tensor_list` with nranks Tensors
    (reference `dist.all_gather`)."""
    _refuse_multiproc("all_gather")
    g = _group(group)
    stacked, _ = _as_stack(tensor, g)
    out = [Tensor(stacked[i]) for i in range(g.nranks)]
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(out)
    return out


def gather(tensor: Tensor, gather_list=None, dst=0, group=None, sync_op=True):
    return all_gather(gather_list, tensor, group, sync_op)


def scatter(tensor: Tensor, tensor_list: Optional[List[Tensor]] = None,
            src=0, group=None, sync_op=True):
    """Scatter `tensor_list` (on src) to ranks: the result is the per-rank
    stack (reference `dist.scatter`)."""
    _refuse_multiproc("scatter")
    g = _group(group)
    if tensor_list:
        stacked = torch.stack([_value(t) for t in tensor_list])
    else:
        arr = _value(tensor)
        stacked = arr.reshape((g.nranks, -1) + tuple(arr.shape[1:])) \
            if arr.shape[0] % g.nranks == 0 else arr
    tensor._data = _run_compiled("scatter", g, lambda x: x.clone(), stacked)
    _mark_stacked(tensor)
    return _FinishedTask(tensor)


def reduce_scatter(tensor: Tensor, tensor_list=None, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Reduce the per-rank stacks then scatter chunks
    (reference `dist.reduce_scatter`)."""
    _refuse_multiproc("reduce_scatter")
    g = _group(group)
    if tensor_list is not None:
        src = _mark_stacked(Tensor(torch.stack([_value(t)
                                                for t in tensor_list])))
    else:
        src = tensor
    # build [n, n*chunk, ...] stack: each rank's input is the full list concat
    stacked, _ = _as_stack(src, g)
    if tensor_list is not None:
        # single-controller list path: every rank holds the same concat
        flat = stacked.reshape((1, stacked.shape[0] * stacked.shape[1])
                               + tuple(stacked.shape[2:]))
        stacked = flat.expand((g.nranks,) + tuple(flat.shape[1:]))
    out = _run_compiled("reduce_scatter", g,
                        _program("reduce_scatter", g, op), stacked)
    tensor._data = out
    _mark_stacked(tensor)
    return _FinishedTask(tensor)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """All-to-all (reference `dist.alltoall`): rank r sends in[r][j] to rank
    j. Inputs: list of nranks tensors (the per-destination chunks)."""
    _refuse_multiproc("alltoall")
    g = _group(group)
    if isinstance(in_tensor_list, Tensor):
        stacked, _ = _as_stack(in_tensor_list, g)
    else:
        per_rank = torch.stack([_value(t) for t in in_tensor_list])
        # single-controller: every rank sends the same chunk list
        stacked = per_rank.reshape((1, -1) + tuple(per_rank.shape[2:])) \
            .expand((g.nranks, per_rank.shape[0] * per_rank.shape[1])
                    + tuple(per_rank.shape[2:])) \
            if per_rank.dim() > 1 else per_rank
    out = _run_compiled("alltoall", g, _program("alltoall", g, None),
                        stacked)
    chunks = out.reshape((g.nranks, g.nranks, -1) + tuple(out.shape[2:]))
    result = [Tensor(chunks[i, i]) for i in range(g.nranks)]
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(result)
    return result


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    g = _group(group)
    t = in_tensor if isinstance(in_tensor, Tensor) else Tensor(in_tensor)
    res = _run("alltoall", _mark_stacked(Tensor(_value(t))) if
               _value(t).shape[0] == g.nranks else t, group, in_place=False)
    out_tensor._data = res._data
    return _FinishedTask(out_tensor)


# -- p2p (single-controller mailbox + ring shift) ---------------------------

_mailbox = {}


def send(tensor: Tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send (reference `dist.send`). The one process plays
    every rank, so values queue per group and `recv(src=...)` pops them
    FIFO whatever the declared src / dst ranks."""
    _refuse_multiproc("send")
    g = _group(group)
    _mailbox.setdefault(g.id, collections.deque()).append(_value(tensor))
    return _FinishedTask(tensor)


def recv(tensor: Tensor, src=0, group=None, sync_op=True):
    """Receive into `tensor` (reference `dist.recv`); a recv before any
    send raises."""
    _refuse_multiproc("recv")
    g = _group(group)
    queue = _mailbox.get(g.id)
    if not queue:
        raise RuntimeError(
            f"recv(src={src}): no matching send posted (group "
            f"{g.id}). In single-controller mode send() must "
            f"run before the matching recv().")
    tensor._data = queue.popleft()
    return _FinishedTask(tensor)


isend = send  # send is buffered, hence already non-blocking


class _DeferredMailboxRecv:
    """Single-controller irecv handle: the mailbox pop happens at wait()
    time, so recv-before-send batch patterns complete once the matching
    send has been posted. wait() is idempotent (pops exactly once);
    is_completed() before wait() reports message availability on the
    group channel."""

    def __init__(self, tensor, src, group):
        self._tensor = tensor
        self._src = src
        self._group = group
        self._done = False

    def wait(self):
        if not self._done:
            recv(self._tensor, src=self._src, group=self._group)
            self._done = True
        return self._tensor

    def is_completed(self):
        if self._done:
            return True
        q = _mailbox.get(_group(self._group).id)
        return bool(q)


def irecv(tensor: Tensor, src=0, group=None, sync_op=False):
    """Non-blocking receive: posts the receive and returns a waitable
    task, so recv-before-send patterns (batch_isend_irecv) complete."""
    _refuse_multiproc("irecv")
    return _DeferredMailboxRecv(tensor, src, group)


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    return [op.op(op.tensor, op.peer, op.group) for op in p2p_op_list]


def p2p_shift(tensor: Tensor, offset: int = 1, group=None) -> Tensor:
    """Ring shift over the group axis (`ppermute`): out[r] = in[(r-offset)%n].
    The p2p primitive pipeline schedules build on."""
    return _run("shift", tensor, group, extra=int(offset), in_place=False)


def _sync_device() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def barrier(group=None):
    """Every rank arrives: the one process waits for its card, guarded by
    the comm watchdog (`watchdog.py`, CommTaskManager analog)."""
    from .watchdog import watchdog_guard

    if _multiproc():
        raise MultiProcessNotPorted("barrier")
    with watchdog_guard("barrier"):
        _group(group)
        _sync_device()
    return _FinishedTask(None)


def wait(tensor=None, group=None, use_calc_stream=True):
    if isinstance(tensor, Tensor):
        _sync_device()


# -- object collectives ------------------------------------------------------

def all_gather_object(object_list: List, obj, group=None):
    """Gather python objects from every rank (reference
    `dist.all_gather_object`): every rank's object is this process's."""
    _refuse_multiproc("all_gather_object")
    g = _group(group)
    object_list.clear()
    object_list.extend([obj] * g.nranks)


def broadcast_object_list(object_list: List, src=0, group=None):
    """Broadcast a python object list from rank `src`: every rank holds
    this process's list already."""
    _refuse_multiproc("broadcast_object_list")
    return object_list


def scatter_object_list(out_object_list: List, in_object_list=None, src=0,
                        group=None):
    _refuse_multiproc("scatter_object_list")
    out_object_list.clear()
    if in_object_list:
        out_object_list.append(in_object_list[0])


class _FinishedTask:
    """Collective task handle (the reference returns an async task; the
    work is issued already, so wait() waits for the card)."""

    def __init__(self, result):
        self._result = result

    def wait(self):
        if isinstance(self._result, Tensor):
            _sync_device()

    def is_completed(self):
        return True


class _StreamNS:
    """`paddle.distributed.stream.*` parity: the stream-ordered variants
    are the same collectives (the card runs them in stream order)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    reduce_scatter = staticmethod(reduce_scatter)
    scatter = staticmethod(scatter)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    send = staticmethod(send)
    recv = staticmethod(recv)


stream = _StreamNS()
