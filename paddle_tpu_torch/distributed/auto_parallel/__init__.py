"""Semi-auto parallelism (the port of `paddle_tpu/distributed/auto_parallel/`;
reference `python/paddle/distributed/auto_parallel/`). The JAX package's
`Engine` is not ported yet."""
from ..process_mesh import get_mesh, set_mesh  # noqa: F401
from . import sharding_bridge  # noqa: F401
from .api import (ShardDataloader, ShardingStage1, ShardingStage2,  # noqa: F401
                  ShardingStage3, dtensor_from_local, dtensor_to_local,
                  is_dist_tensor, placements_of, process_mesh_of, reshard,
                  shard_dataloader, shard_layer, shard_optimizer, shard_tensor,
                  unshard_dtensor)
from .strategy import Strategy  # noqa: F401

__all__ = ["shard_tensor", "reshard", "shard_layer", "shard_optimizer",
           "dtensor_from_local", "dtensor_to_local", "unshard_dtensor",
           "ShardingStage1", "ShardingStage2", "ShardingStage3",
           "shard_dataloader", "ShardDataloader", "get_mesh", "set_mesh",
           "Strategy"]
