"""Parallel environment and eager DataParallel (the port of
`paddle_tpu/distributed/parallel.py`; reference
`python/paddle/distributed/parallel.py`, `init_parallel_env:978`,
`DataParallel:219`).

Single-controller, as in the JAX package: the ranks are those of the
emulated world (`process_mesh.emulated_world()`), and
`init_parallel_env` sets the default `world` mesh over them. Under the
launch contract of several processes (`PADDLE_TRAINERS_NUM > 1`) it
raises `MultiProcessNotPorted`: that convention is the next distributed
slice's.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core.tensor import Tensor
from .communication.collective import MultiProcessNotPorted
from .communication.group import Group, _get_global_group
from .process_mesh import ProcessMesh, emulated_world, get_mesh, set_mesh

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "DataParallel", "is_available"]

_initialized = [False]


def is_available() -> bool:
    return True


def init_parallel_env() -> Optional[Group]:
    """Initialise the single-controller world (reference
    `dist.init_parallel_env`, `parallel.py:978`): the global group over
    the emulated ranks, the default `world` mesh, and the `mesh.*`
    gauges."""
    if int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) > 1:
        raise MultiProcessNotPorted("init_parallel_env with "
                                    "PADDLE_TRAINERS_NUM > 1")
    if _initialized[0]:
        return _get_global_group()
    n = emulated_world()
    if get_mesh() is None:
        set_mesh(ProcessMesh(np.arange(n), ["world"]))
    _initialized[0] = True
    # topology gauges: who this host is and how many ranks it drives
    from ..framework import monitor

    monitor.set_gauge("mesh.hosts", 1)
    monitor.set_gauge("mesh.host_rank", 0)
    monitor.set_gauge("mesh.devices", n)
    return _get_global_group()


def get_rank(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.rank
    return int(os.environ.get("PADDLE_TRAINER_ID", 0))


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    if "PADDLE_TRAINERS_NUM" in os.environ:
        return int(os.environ["PADDLE_TRAINERS_NUM"])
    return emulated_world()


class ParallelEnv:
    """Env snapshot (reference `paddle.distributed.ParallelEnv`)."""

    def __init__(self):
        self.rank = get_rank()
        self.world_size = get_world_size()
        self.device_id = self.rank
        self.dev_id = self.rank

    @property
    def local_rank(self):
        return self.rank

    @property
    def nranks(self):
        return self.world_size

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")


class DataParallel:
    """Eager data-parallel model wrapper (reference `DataParallel`,
    `parallel.py:219`, and `EagerReducer`).

    As in the JAX package: the parameters are replicated over the mesh
    and each input batch is `Shard(0)` over the 'dp' (or sole) mesh axis
    where its batch divides; the gradients of the replicated parameters
    are computed on the global batch, which is the all-reduced gradient,
    so `scale_loss` and `apply_collective_grads` are no-ops, and
    comm_buffer_size / find_unused_parameters are accepted for API
    parity."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, mesh: Optional[ProcessMesh] = None,
                 shard_input: bool = True):
        from .auto_parallel.api import _shard_param_inplace
        from .placement import Replicate

        self._layers = layers
        self._mesh = mesh or get_mesh()
        self._shard_input = shard_input
        if self._mesh is not None:
            placements = [Replicate() for _ in range(self._mesh.ndim)]
            for p in layers.parameters():
                _shard_param_inplace(p, self._mesh, placements)

    def _dp_axis(self):
        names = self._mesh.dim_names
        return names.index("dp") if "dp" in names else 0

    def forward(self, *inputs, **kwargs):
        if self._mesh is not None and self._shard_input:
            from .auto_parallel.api import shard_tensor
            from .placement import Replicate, Shard

            axis = self._dp_axis()

            def shard_in(x):
                if isinstance(x, Tensor) and x.ndim >= 1 and \
                        x.shape[0] % self._mesh.shape[axis] == 0:
                    placements = [Replicate()] * self._mesh.ndim
                    placements[axis] = Shard(0)
                    return shard_tensor(x, self._mesh, placements,
                                        stop_gradient=x.stop_gradient)
                return x

            inputs = tuple(shard_in(x) for x in inputs)
            kwargs = {k: shard_in(v) for k, v in kwargs.items()}
        return self._layers(*inputs, **kwargs)

    __call__ = forward

    def __getattr__(self, item):
        return getattr(self._layers, item)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass
