"""Semi-auto parallel dygraph API (the port of
`paddle_tpu/distributed/auto_parallel/api.py`).

Reference surface: `python/paddle/distributed/auto_parallel/api.py`
(`shard_tensor:181`, `reshard:703`, `shard_layer:804`,
`shard_optimizer:1512`, `dtensor_from_local:617`, ShardingStage1/2/3
`:1273,1334,1420`).

Single-controller, as in the JAX package: a DistTensor is a `Tensor`
over the global torch tensor plus its `DistMeta` (`sharding_bridge.py`),
and every op on it computes on the global value. Each rank's shard is a
view of that tensor (`Tensor.local_shards()`); `reshard` re-places a
copy of the value (reducing a Partial's hidden axis first), and
`shard_optimizer` gives the optimizer's moments (torch tensors) their
placements when they are created. The JAX package's GSPMD propagation
has no counterpart: a parameter keeps the placement it was given, and an
op's result is a plain Tensor.

A Tensor whose value is pending in a lazy region is flushed first
(`core/lazy.py` `materialize`): `jax.device_put` is a value barrier of
the JAX package's lazy mode.
"""
from __future__ import annotations

import weakref
from typing import Callable, List, Optional

import torch

from ...core import lazy
from ...core.tensor import Tensor
from ..placement import Placement, Replicate, Shard
from ..process_mesh import ProcessMesh, get_mesh
from . import sharding_bridge as sb

__all__ = ["shard_tensor", "reshard", "dtensor_from_local", "dtensor_to_local",
           "unshard_dtensor", "shard_layer", "shard_optimizer",
           "ShardingStage1", "ShardingStage2", "ShardingStage3",
           "placements_of", "process_mesh_of", "is_dist_tensor",
           "shard_dataloader", "ShardDataloader"]


# ---------------------------------------------------------------------------
# introspection helpers (Tensor.process_mesh / placements analogs)
# ---------------------------------------------------------------------------

def is_dist_tensor(t) -> bool:
    return sb.meta_of(t) is not None


def placements_of(t):
    m = sb.meta_of(t)
    return list(m.placements) if m else None


def process_mesh_of(t):
    m = sb.meta_of(t)
    return m.mesh if m else None


# ---------------------------------------------------------------------------
# shard_tensor / reshard
# ---------------------------------------------------------------------------

def _normalize_placements(mesh: ProcessMesh, placements):
    if placements is None:
        return [Replicate() for _ in range(mesh.ndim)]
    placements = list(placements)
    while len(placements) < mesh.ndim:
        placements.append(Replicate())
    return placements


def _placed(arr: torch.Tensor, mesh, placements, sg: bool,
            grad_path: bool) -> Tensor:
    """A Tensor over a copy of `arr` carrying `DistMeta(mesh,
    placements)`; the copy stays on `arr`'s tape when `grad_path`."""
    meta = sb.DistMeta(mesh, placements)
    if grad_path and not sg and arr.requires_grad:
        out = Tensor._wrap(arr.clone())
    else:
        out = Tensor._wrap(arr.detach().clone())
        out.stop_gradient = sg
    sb.set_meta(out, meta)
    return out


def shard_tensor(data, mesh: Optional[ProcessMesh] = None, placements=None,
                 dtype=None, place=None, stop_gradient=None) -> Tensor:
    """Distribute `data` over `mesh` with `placements`
    (reference `dist.shard_tensor`, `auto_parallel/api.py:181`)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise ValueError("no mesh given and no global mesh set "
                         "(dist.auto_parallel.set_mesh)")
    placements = _normalize_placements(mesh, placements)
    src = data if isinstance(data, Tensor) else Tensor(data, place=place)
    if dtype is not None:
        from ...framework import dtype as dtype_mod

        src = Tensor(lazy.materialize(src).to(
            dtype_mod.convert_dtype(dtype).torch_dtype),
            stop_gradient=src.stop_gradient)
    sg = src.stop_gradient if stop_gradient is None else stop_gradient
    arr = lazy.materialize(src)

    if any(p.is_partial() for p in placements):
        with torch.no_grad():
            stored = sb.expand_partial(arr.detach(), mesh, placements)
        return _placed(stored, mesh, placements, sg, grad_path=False)

    out = _placed(arr, mesh, placements, sg, grad_path=True)
    if isinstance(data, Tensor):
        out.name = data.name
        out.persistable = data.persistable
    return out


def reshard(dist_tensor: Tensor, mesh: Optional[ProcessMesh] = None,
            placements=None) -> Tensor:
    """Convert placements (reference `dist.reshard`, `api.py:703`): a
    Partial source is reduced over its hidden axes first (p->r, p->s),
    then the value takes the new placements (s->r, s->s', r->p)."""
    mesh = mesh or process_mesh_of(dist_tensor) or get_mesh()
    placements = _normalize_placements(mesh, placements)
    src_meta = sb.meta_of(dist_tensor)
    arr = lazy.materialize(dist_tensor)
    sg = dist_tensor.stop_gradient
    broke = False
    if src_meta is not None and src_meta.partial_dims:
        with torch.no_grad():
            arr = sb.reduce_partial(arr.detach(), src_meta)
        broke = True                    # the reduction leaves the tape

    if any(p.is_partial() for p in placements):
        with torch.no_grad():
            stored = sb.expand_partial(arr.detach(), mesh, placements)
        return _placed(stored, mesh, placements, sg, grad_path=False)
    return _placed(arr, mesh, placements, sg, grad_path=not broke)


def dtensor_from_local(local_tensor, mesh: ProcessMesh, placements) -> Tensor:
    """Assemble a DistTensor from the local shard (reference
    `dist.dtensor_from_local`, `api.py:617`). Single-controller: every
    rank's shard is `local_tensor`, so the global value tiles it along
    each sharded dim."""
    placements = _normalize_placements(mesh, placements)
    if any(p.is_partial() for p in placements):
        raise NotImplementedError("dtensor_from_local with Partial: reshard "
                                  "after assembly instead")
    local = lazy.materialize(local_tensor) \
        if isinstance(local_tensor, Tensor) else torch.as_tensor(local_tensor)
    reps = [1] * local.dim()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            reps[p.dim] *= mesh.shape[i]
    out = Tensor._wrap(local.detach().repeat(*reps) if reps
                       else local.detach().clone())
    out.stop_gradient = getattr(local_tensor, "stop_gradient", True)
    sb.set_meta(out, sb.DistMeta(mesh, placements))
    return out


def dtensor_to_local(dist_tensor: Tensor, mesh=None, placements=None) -> Tensor:
    """The local shard (reference `dist.dtensor_to_local`): the first
    rank's, as the JAX package reads `addressable_shards[0]`."""
    return Tensor(sb.local_shards(dist_tensor)[0][2].detach().clone())


def unshard_dtensor(dist_tensor: Tensor) -> Tensor:
    """Gather to a fully replicated dense tensor (reference
    `dist.unshard_dtensor`)."""
    meta = sb.meta_of(dist_tensor)
    if meta is None:
        return dist_tensor
    rep = reshard(dist_tensor, meta.mesh,
                  [Replicate() for _ in range(meta.mesh.ndim)])
    out = Tensor._wrap(rep._data)
    out.stop_gradient = dist_tensor.stop_gradient
    out.__dict__["_dist_meta"] = None
    rep._data._dist_meta = None
    return out


# ---------------------------------------------------------------------------
# shard_layer / shard_optimizer (ZeRO placement strategies)
# ---------------------------------------------------------------------------

def _shard_param_inplace(p, mesh, placements):
    """Give parameter `p` its placements; its storage (the global value)
    stays, so the optimizer and the tape keep the same leaf."""
    sb.set_meta(p, sb.DistMeta(mesh, list(placements)))


def shard_layer(layer, process_mesh: ProcessMesh,
                shard_fn: Optional[Callable] = None,
                input_fn: Optional[Callable] = None,
                output_fn: Optional[Callable] = None):
    """Shard every parameter of `layer` over `process_mesh` (reference
    `dist.shard_layer`, `api.py:804`). `shard_fn(name, layer, mesh)`
    customises per-sublayer placements; the default replicates."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for p in sublayer.parameters(include_sublayers=False):
                _shard_param_inplace(
                    p, mesh, [Replicate() for _ in range(mesh.ndim)])

    for name, sub in layer.named_sublayers(include_self=True):
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda lyr, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


class _ShardingStageBase:
    """Optimizer-state placement rewriters (reference ShardingStage1/2/3,
    `auto_parallel/api.py:1273-1420`, the semi-auto face of ZeRO)."""

    def __init__(self, mesh=None, sharding_mesh_dim=None):
        self._mesh = mesh
        self._dim = sharding_mesh_dim

    def _axis(self, mesh: ProcessMesh):
        if self._dim is None:
            if mesh.ndim == 1:
                return 0
            # a real (size > 1) sharding-capable axis: the dedicated
            # "sharding" axis first, then dp
            for cand in ("sharding", "dp"):
                if cand in mesh.dim_names and \
                        mesh.shape[mesh.dim_names.index(cand)] > 1:
                    return mesh.dim_names.index(cand)
            return 0
        if isinstance(self._dim, str):
            return mesh.dim_names.index(self._dim)
        return self._dim

    def _shard_spec_for(self, shape, mesh) -> Optional[List[Placement]]:
        """Placements sharding dim0 over the sharding axis when divisible."""
        axis = self._axis(mesh)
        if not shape or shape[0] % mesh.shape[axis] != 0:
            return None
        placements: List[Placement] = [Replicate()] * mesh.ndim
        placements[axis] = Shard(0)
        return placements


class ShardingStage1(_ShardingStageBase):
    """Shard optimizer states (accumulators) over the sharding axis."""

    shard_param = False
    shard_acc = True


class ShardingStage2(ShardingStage1):
    """Stage 2 = stage 1 states + sharded gradients. Gradients are
    computed on the global value here, so the placement rewrite is stage
    1's, as in the JAX package."""


class ShardingStage3(_ShardingStageBase):
    """Also shard the parameters themselves (ZeRO-3)."""

    shard_param = True
    shard_acc = True


def _place_state(acc: torch.Tensor, p, mesh, shard_fn) -> None:
    """Give an optimizer state tensor of parameter `p` its placements:
    by the stage's rule, or like `p` when there is no stage."""
    if mesh is None or acc.dim() == 0:
        return
    if shard_fn is not None:
        spec = shard_fn._shard_spec_for(list(acc.shape), mesh)
        if spec is not None:
            sb.set_meta(acc, sb.DistMeta(mesh, spec))
        return
    meta = sb.meta_of(p)
    if meta is not None and tuple(acc.shape) == tuple(p.shape):
        sb.set_meta(acc, sb.DistMeta(meta.mesh, list(meta.placements)))


class _ShardedOptimizer:
    """Wraps an Optimizer so its state is created with placements
    (reference `dist.shard_optimizer`, `api.py:1512`): each moment by the
    stage's rule (dim 0 over the sharding axis where it divides), or,
    without a stage, like its parameter; an f32 master weight like its
    parameter (the JAX package's master is the parameter's `astype`,
    which keeps its sharding). `step` is the inner optimizer's: a
    parameter keeps the placement it was given, so stages 1 and 2 have
    nothing to re-replicate after the update."""

    def __init__(self, optimizer, shard_fn=None, mesh=None):
        self._inner = optimizer
        self._shard_fn = shard_fn
        self._mesh = mesh = mesh or get_mesh()
        if shard_fn is not None and getattr(shard_fn, "shard_param", False):
            for p in optimizer._params:
                if isinstance(p, Tensor):
                    spec = shard_fn._shard_spec_for(list(p.shape), mesh)
                    if spec is not None:
                        _shard_param_inplace(p, mesh, spec)
        # the hook holds the optimizer weakly and calls the class's
        # method: a reference cycle through the instance would keep a
        # dropped optimizer's state alive until the cyclic collector ran
        ensure = type(optimizer)._ensure_state
        opt_ref = weakref.ref(optimizer)

        def sharded_ensure(p):
            opt = opt_ref()
            fresh = [n for n in opt._acc_names
                     if id(p) not in opt._accumulators[n]]
            had_master = id(p) in opt._master_weights
            ensure(opt, p)
            for n in fresh:
                _place_state(opt._accumulators[n][id(p)], p, mesh, shard_fn)
            if not had_master and id(p) in opt._master_weights:
                _place_state(opt._master_weights[id(p)], p, mesh, None)

        optimizer._ensure_state = sharded_ensure

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def __setattr__(self, item, value):
        if item in ("_inner", "_shard_fn", "_mesh"):
            object.__setattr__(self, item, value)
        else:  # forward config writes (e.g. amp.decorate's master-weight flag)
            setattr(self._inner, item, value)


def shard_optimizer(optimizer, shard_fn=None, mesh=None):
    return _ShardedOptimizer(optimizer, shard_fn, mesh)


# ---------------------------------------------------------------------------
# shard_dataloader
# ---------------------------------------------------------------------------

class ShardDataloader:
    """Wrap a DataLoader so each batch is shard_tensor'd over the mesh
    (reference `dist.shard_dataloader`, `api.py:3016`)."""

    def __init__(self, dataloader, meshes, input_keys=None, shard_dims=0,
                 is_dataset_splitted=False):
        self._loader = dataloader
        self._mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
        self._shard_dims = shard_dims
        self._input_keys = input_keys

    def __len__(self):
        return len(self._loader)

    def _dim_for(self, key=None, index=None):
        """Resolve the reference's polymorphic shard_dims: int | str mesh-dim
        name | list per-position | dict per-input-key."""
        sd = self._shard_dims
        if isinstance(sd, dict):
            sd = sd.get(key, 0)
        elif isinstance(sd, (list, tuple)):
            sd = sd[index] if index is not None and index < len(sd) else 0
        if isinstance(sd, str):  # a mesh axis name means "shard dim 0 on it"
            return 0, sd
        return sd, None

    def _shard_item(self, item, key=None, index=None):
        if isinstance(item, Tensor):
            if self._input_keys and key is not None and \
                    key not in self._input_keys:
                return item
            dim, axis_name = self._dim_for(key, index)
            placements: List[Placement] = [Replicate()] * self._mesh.ndim
            if dim is not None:
                if axis_name is not None and axis_name in self._mesh.dim_names:
                    axis = self._mesh.dim_names.index(axis_name)
                else:
                    axis = 0 if self._mesh.ndim == 1 else (
                        self._mesh.dim_names.index("dp")
                        if "dp" in self._mesh.dim_names else 0)
                placements[axis] = Shard(dim)
            return shard_tensor(item, self._mesh, placements)
        return item

    def __iter__(self):
        for batch in self._loader:
            if isinstance(batch, dict):
                yield {k: self._shard_item(v, key=k)
                       for k, v in batch.items()}
            elif isinstance(batch, (list, tuple)):
                yield type(batch)(self._shard_item(v, index=i)
                                  for i, v in enumerate(batch))
            else:
                yield self._shard_item(batch)


def shard_dataloader(dataloader, meshes, input_keys=None, shard_dims=0,
                     is_dataset_splitted=False) -> ShardDataloader:
    return ShardDataloader(dataloader, meshes, input_keys, shard_dims,
                           is_dataset_splitted)
