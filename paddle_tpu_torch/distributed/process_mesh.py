"""ProcessMesh — the process topology of the auto-parallel API (the port
of `paddle_tpu/distributed/process_mesh.py`).

A mesh is an n-d array of ranks with a name per axis. Two worlds read
it:

- the single-controller world of the auto-parallel API (DistTensors,
  `reshard`, the eager collectives, `DataParallel`): one process plays
  every rank of an *emulated world*, the counterpart of the JAX
  package's virtual-device count. Its size is set explicitly by
  `set_emulated_world(n)` (default: the number of cards the process
  sees, at least 1); `default_mesh()` spans it, and `set_mesh` /
  `get_mesh` keep the global default mesh, as in the JAX package;
- `torch.distributed` worlds, one process a rank:
  `serving.tp.shard_engine` reads a `(dp, tp)` mesh row-major, each dp
  row one tensor-parallel group.

The JAX package's `to_jax_mesh` (the bridge to `jax.sharding.Mesh`) has
no counterpart here: a DistTensor's shards are slices of one global
torch tensor (`auto_parallel/sharding_bridge.py`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["ProcessMesh", "set_mesh", "get_mesh", "default_mesh",
           "set_emulated_world", "emulated_world"]

_global_mesh: Optional["ProcessMesh"] = None
_emulated_world: Optional[int] = None


class ProcessMesh:
    def __init__(self, mesh: Sequence, dim_names: Optional[List[str]] = None,
                 shape=None, process_ids=None):
        if shape is not None and process_ids is not None:
            arr = np.asarray(process_ids, dtype=np.int64).reshape(shape)
        else:
            arr = np.asarray(mesh, dtype=np.int64)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"dim_names {dim_names} does not match mesh ndim {arr.ndim}")
        if len(set(dim_names)) != len(dim_names):
            raise ValueError(f"duplicate dim_names: {dim_names}")
        self._mesh = arr
        self._dim_names = list(dim_names)

    @property
    def mesh(self) -> np.ndarray:
        return self._mesh

    @property
    def shape(self) -> List[int]:
        return list(self._mesh.shape)

    @property
    def ndim(self) -> int:
        return self._mesh.ndim

    @property
    def size(self) -> int:
        return int(self._mesh.size)

    @property
    def process_ids(self) -> List[int]:
        return [int(x) for x in self._mesh.flatten()]

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    def get_dim_size(self, dim_name: str) -> int:
        return self._mesh.shape[self._dim_names.index(dim_name)]

    def get_rank_by_dim_and_process_id(self, dim_name, process_id):
        axis = self._dim_names.index(dim_name)
        where = np.argwhere(self._mesh == process_id)
        if where.size == 0:
            return -1
        return int(where[0][axis])

    def get_mesh_with_dim(self, dim_name, index=None):
        """Sub-mesh obtained by moving `dim_name` first (and optionally
        indexing it) — reference `ProcessMesh.get_mesh_with_dim`."""
        axis = self._dim_names.index(dim_name)
        perm = [axis] + [i for i in range(self.ndim) if i != axis]
        names = [self._dim_names[i] for i in perm]
        moved = np.transpose(self._mesh, perm)
        if index is not None:
            return ProcessMesh(moved[index], names[1:])
        return ProcessMesh(moved, names)

    def __getitem__(self, index):
        sub = self._mesh[index]
        if sub.ndim == self.ndim:
            return ProcessMesh(sub, self._dim_names)
        return ProcessMesh(sub, self._dim_names[1:]) if sub.ndim else \
            ProcessMesh(sub.reshape(1), self._dim_names[-1:])

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._mesh.shape == other._mesh.shape
                and (self._mesh == other._mesh).all()
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._mesh.tobytes(), self._mesh.shape,
                     tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, dim_names={self._dim_names},"
                f" process_ids={self.process_ids})")

    def describe(self) -> dict:
        """Observability view of the topology: shape, axes and size, plus
        the processes of the initialized `torch.distributed` world (1
        without one) and the CUDA cards this process sees."""
        import torch
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_available() \
            and dist.is_initialized() else 1
        return {"shape": self.shape, "dim_names": self.dim_names,
                "size": self.size, "processes": world,
                "local_devices": torch.cuda.device_count()}


def set_emulated_world(n: Optional[int]) -> None:
    """Set the number of ranks the single-controller world emulates (the
    counterpart of the JAX package's virtual-device count); None
    restores the default, the number of cards this process sees."""
    global _emulated_world
    if n is not None and int(n) < 1:
        raise ValueError(f"an emulated world needs at least one rank, "
                         f"got {n}")
    _emulated_world = None if n is None else int(n)


def emulated_world() -> int:
    """The ranks of the emulated world: as set, else the cards this
    process sees (at least 1)."""
    if _emulated_world is not None:
        return _emulated_world
    import torch

    return max(torch.cuda.device_count(), 1)


def set_mesh(mesh: Optional[ProcessMesh]):
    """Set the global default mesh (reference `dist.auto_parallel.set_mesh`)."""
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


def default_mesh(ndev: Optional[int] = None) -> ProcessMesh:
    """1-D world mesh over the emulated world's ranks."""
    n = ndev or emulated_world()
    return ProcessMesh(np.arange(n), ["world"])
