"""DistMeta, the placement rules and the reshard helpers (the port of
`paddle_tpu/distributed/auto_parallel/sharding_bridge.py`).

A DistTensor is a paddle `Tensor` over the *global* torch tensor plus a
`DistMeta` (its mesh and one placement per mesh dim), in the one
process that plays every rank of the emulated world. Where the JAX
package's `jax.Array` carries a `NamedSharding` and lists its
`addressable_shards`, the port derives each rank's shard from the meta
by the same even-split rule (`shard_slices`): a tensor dim split over
mesh axes `(a, b, ...)` (in mesh-dim order, the first the most
significant) gives rank `r` at mesh coordinate `c` the block
`ravel(c[a], c[b], ...)` of `dim / (|a| |b| ...)` rows, and a dim that
does not divide raises the JAX package's `ValueError`. Every shard is a
view of the global tensor.

Partial placements (`Partial(sum)` etc.) are a *hidden stacked axis*,
as in the JAX package: a tensor partial over mesh dim k stores the
per-rank contributions in an extra leading dim of size mesh.shape[k],
split over that mesh axis. `reduce_partial` sums it away (Partial ->
Replicate); `expand_partial` gives a value its hidden dims, slot 0 the
value and the other slots the reduction's neutral element.

Reductions over a stacked axis (`reduce_stacked`, also the eager
collectives') run in rank order, one elementwise op a rank, so one world
gives the same bits on every run and on every device.

The JAX package's `partition_spec` / `named_sharding` (the bridge to
`jax.sharding`) and `infer_meta_from_array` (a jax.Array's sharding read
back) have no counterpart: the meta is the only record of a placement.
A torch tensor the port keeps outside a Tensor (an optimizer's moment)
carries its meta as the attribute `_dist_meta`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..placement import Placement, Shard
from ..process_mesh import ProcessMesh

__all__ = ["DistMeta", "stored_shape", "logical_shape", "stored_axes",
           "check_divisible", "check_placeable", "shard_slices",
           "local_shards",
           "expand_partial", "reduce_partial", "reduce_stacked", "meta_of",
           "set_meta"]


class DistMeta:
    """Tensor-side distributed attribute (analog of `TensorDistAttr`,
    `phi/core/distributed/auto_parallel/dist_attr.h`)."""

    __slots__ = ("mesh", "placements")

    def __init__(self, mesh: ProcessMesh, placements: Sequence[Placement]):
        if len(placements) != mesh.ndim:
            raise ValueError(
                f"need {mesh.ndim} placements for mesh {mesh.shape}, got "
                f"{len(placements)}")
        self.mesh = mesh
        self.placements = tuple(placements)

    @property
    def partial_dims(self) -> List[int]:
        return [i for i, p in enumerate(self.placements) if p.is_partial()]

    def __eq__(self, other):
        return (isinstance(other, DistMeta) and self.mesh == other.mesh
                and self.placements == other.placements)

    def __repr__(self):
        return f"DistMeta(mesh={self.mesh.shape}, placements={self.placements})"


def stored_shape(global_shape: Tuple[int, ...], mesh: ProcessMesh,
                 placements: Sequence[Placement]) -> Tuple[int, ...]:
    hidden = tuple(mesh.shape[i] for i, p in enumerate(placements)
                   if p.is_partial())
    return hidden + tuple(global_shape)


def logical_shape(stored: Tuple[int, ...], meta: DistMeta) -> Tuple[int, ...]:
    return tuple(stored[len(meta.partial_dims):])


def stored_axes(mesh: ProcessMesh, placements: Sequence[Placement],
                ndim: int) -> List[List[int]]:
    """For each dim of the *stored* tensor (hidden partial dims first,
    then the `ndim` logical ones), the mesh dims that split it, in mesh
    order (the JAX package's `partition_spec`)."""
    axes: List[List[int]] = [[i] for i, p in enumerate(placements)
                             if p.is_partial()]
    dims: List[List[int]] = [[] for _ in range(ndim)]
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim if p.dim >= 0 else p.dim + ndim
            if d >= ndim or d < 0:
                raise ValueError(f"Shard({p.dim}) out of range for ndim {ndim}")
            dims[d].append(i)
    return axes + dims


def check_divisible(shape, mesh: ProcessMesh, axes) -> None:
    """Raise the JAX package's `ValueError` (`jax.device_put`'s) when a
    split dim does not divide by its mesh axes."""
    for d, ax in enumerate(axes):
        count = int(np.prod([mesh.shape[i] for i in ax])) if ax else 1
        if count > 1 and int(shape[d]) % count:
            raise ValueError(
                f"a placement over mesh {mesh.shape} ({mesh.dim_names}) "
                f"implies that the global size of its dimension {d} should "
                f"be divisible by {count}, but it is equal to {shape[d]} "
                f"(full shape: {tuple(int(s) for s in shape)})")


def shard_slices(shape, mesh: ProcessMesh, axes):
    """`[(rank, offset, slices)]`, one entry a mesh position in rank
    order: the block of the stored tensor `shape` that rank holds."""
    check_divisible(shape, mesh, axes)
    out = []
    for coord in np.ndindex(*mesh.shape):
        rank = int(mesh.mesh[coord])
        offset, slices = [], []
        for d, ax in enumerate(axes):
            count, idx = 1, 0
            for i in ax:
                idx = idx * mesh.shape[i] + coord[i]
                count *= mesh.shape[i]
            chunk = int(shape[d]) // count
            offset.append(idx * chunk)
            slices.append(slice(idx * chunk, (idx + 1) * chunk))
        out.append((rank, tuple(offset), tuple(slices)))
    out.sort(key=lambda e: e[0])
    return out


def _torch_of(t) -> torch.Tensor:
    from ...core import lazy
    from ...core.tensor import Tensor

    return lazy.materialize(t) if isinstance(t, Tensor) else t


def meta_of(t) -> Optional[DistMeta]:
    """The DistMeta of a Tensor (its own, else its torch tensor's) or of
    a torch tensor; None for a tensor that is not distributed."""
    from ...core.tensor import Tensor

    if isinstance(t, Tensor):
        m = t.__dict__.get("_dist_meta")
        if m is not None:
            return m
        t = t._data
    return getattr(t, "_dist_meta", None) if isinstance(t, torch.Tensor) \
        else None


def check_placeable(data, meta: DistMeta) -> None:
    """Raise unless `data` (the stored value) splits evenly by `meta`."""
    shape = tuple(data.shape)
    check_divisible(shape, meta.mesh, stored_axes(
        meta.mesh, meta.placements, len(shape) - len(meta.partial_dims)))


def set_meta(t, meta: Optional[DistMeta]) -> None:
    """Give a Tensor (and its torch tensor) or a torch tensor `meta`,
    after checking that its shape splits evenly."""
    from ...core.tensor import Tensor

    data = t._data if isinstance(t, Tensor) else t
    if meta is not None:
        check_placeable(data, meta)
    if isinstance(t, Tensor):
        t.__dict__["_dist_meta"] = meta
    if isinstance(data, torch.Tensor):
        data._dist_meta = meta


def local_shards(t, meta: Optional[DistMeta] = None):
    """`[(rank, global_offset, torch view)]` of every rank's shard of `t`
    (a Tensor or a torch tensor) in rank order: the counterpart of
    `jax.Array.addressable_shards`. A tensor without a meta is one
    shard, rank 0's."""
    data = _torch_of(t)
    meta = meta or meta_of(t)
    if meta is None:
        return [(0, (0,) * data.dim(), data)]
    n_hidden = len(meta.partial_dims)
    axes = stored_axes(meta.mesh, meta.placements, data.dim() - n_hidden)
    return [(rank, off, data[sl])
            for rank, off, sl in shard_slices(tuple(data.shape), meta.mesh,
                                              axes)]


_NEUTRAL = {"sum": 0.0, "avg": 0.0, "max": None, "min": None, "prod": 1.0,
            "any": 0.0, "all": 1.0}


def expand_partial(arr: torch.Tensor, mesh: ProcessMesh, placements):
    """Give `arr` (the logical value) the hidden stacked dims for its
    Partial placements: slot 0 carries the value, the other slots the
    reduction-neutral element (so an immediate Partial -> Replicate
    round-trips); max / min replicate the value."""
    for i in reversed([i for i, p in enumerate(placements)
                       if p.is_partial()]):
        size = mesh.shape[i]
        neutral = _NEUTRAL[placements[i].reduce_type]
        if neutral is None:
            arr = arr[None].expand((size,) + tuple(arr.shape)).clone()
        else:
            rest = torch.full((size - 1,) + tuple(arr.shape), neutral,
                              dtype=arr.dtype, device=arr.device)
            arr = torch.cat([arr[None], rest], dim=0)
    return arr


def reduce_stacked(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Reduce the leading (rank) axis of `x` in rank order: `sum`, `avg`
    (the sum over the count), `max`, `min`, `prod`, `any`, `all`."""
    if kind in ("any", "all"):
        b = x != 0
        r = b.any(0) if kind == "any" else b.all(0)
        return r.to(x.dtype)
    acc = x[0].clone()
    for r in range(1, x.shape[0]):
        if kind in ("sum", "avg"):
            acc = acc + x[r]
        elif kind == "max":
            acc = torch.maximum(acc, x[r])
        elif kind == "min":
            acc = torch.minimum(acc, x[r])
        elif kind == "prod":
            acc = acc * x[r]
        else:
            raise ValueError(f"unknown reduction {kind!r}")
    if kind == "avg":
        acc = acc / x.shape[0]
    return acc


def reduce_partial(arr: torch.Tensor, meta: DistMeta) -> torch.Tensor:
    """Reduce every hidden stacked dim (Partial -> Replicate), one
    rank-ordered reduction a partial mesh axis."""
    kinds = [meta.placements[i].reduce_type for i in meta.partial_dims]
    for kind in reversed(kinds):
        arr = reduce_stacked(arr, kind)
    return arr
