"""paddle_tpu_torch.distributed: the port of `paddle_tpu/distributed/`.

Two worlds, as `process_mesh.py` sets out:

- the single-controller core (the JAX package's): placements and
  DistTensors (`auto_parallel`: `shard_tensor`, `reshard`, `shard_layer`,
  `shard_optimizer`, the sharding stages, `shard_dataloader`), the eager
  collectives over rank-stacked tensors, groups and the comm watchdog
  (`communication`), `init_parallel_env` and `DataParallel`
  (`parallel.py`), all over the emulated world of
  `set_emulated_world(n)` in one process, whose shards are views of one
  global tensor on one card;
- `torch.distributed` worlds, one process a rank: the tensor-parallel
  collectives the serving engines shard over (`tp_overlap.py`).

`checkpoint` saves a DistTensor shard by shard and re-slices saved
shards onto the destination's placements, in the JAX package's sharded
checkpoint files, both ways. `elastic` keeps the membership store and
manager. Not ported yet: `fleet`, `rpc`, `sharding`, `ring_attention`,
`split`, `auto_parallel.Engine`, and the multi-process convention of
the collectives (`MultiProcessNotPorted`).
"""
from . import auto_parallel  # noqa: F401
from .auto_parallel import Strategy  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from . import elastic  # noqa: F401
from .auto_parallel import (ShardingStage1, ShardingStage2,  # noqa: F401
                            ShardingStage3, dtensor_from_local,
                            dtensor_to_local, reshard, shard_dataloader,
                            shard_layer, shard_optimizer, shard_tensor,
                            unshard_dtensor)
from . import communication  # noqa: F401
from .communication import *  # noqa: F401,F403
from .communication import stream  # noqa: F401
from .communication.collective import MultiProcessNotPorted  # noqa: F401
from .communication.group import (Group, destroy_process_group,  # noqa: F401
                                  get_backend, get_group, is_initialized,
                                  new_group)
from .parallel import (DataParallel, ParallelEnv, get_rank,  # noqa: F401
                       get_world_size, init_parallel_env, is_available)
from .placement import Partial, Placement, Replicate, Shard  # noqa: F401
from .process_mesh import (ProcessMesh, default_mesh,  # noqa: F401
                           emulated_world, get_mesh, set_emulated_world,
                           set_mesh)
from .tp_overlap import (TPInfo, axis_index, gather_columns,  # noqa: F401
                         out_features, row_parallel_matmul,
                         slice_out_channels)

__all__ = [
    "ProcessMesh", "get_mesh", "set_mesh", "Shard", "Replicate", "Partial",
    "Placement", "shard_tensor", "reshard", "shard_layer", "shard_optimizer",
    "dtensor_from_local", "dtensor_to_local", "unshard_dtensor",
    "ShardingStage1", "ShardingStage2", "ShardingStage3", "shard_dataloader",
    "init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
    "DataParallel", "new_group", "get_group", "Group", "is_initialized",
    "destroy_process_group", "get_backend",
    # collectives (from communication)
    "all_reduce", "all_gather", "all_gather_object", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter", "scatter",
    "scatter_object_list", "alltoall", "alltoall_single", "send", "recv",
    "isend", "irecv", "gather", "barrier", "ReduceOp", "P2POp",
    "batch_isend_irecv", "stream", "wait",
    # the port's own
    "set_emulated_world", "emulated_world", "default_mesh", "Strategy",
    "checkpoint", "load_state_dict", "save_state_dict",
    "MultiProcessNotPorted", "TPInfo", "axis_index", "gather_columns",
    "out_features", "row_parallel_matmul", "slice_out_channels",
]
