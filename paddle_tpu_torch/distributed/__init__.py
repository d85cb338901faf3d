"""paddle_tpu_torch.distributed — the process topology and the
tensor-parallel collectives the serving engines shard over (the port of
`paddle_tpu/distributed/process_mesh.py` and `tp_overlap.py`).

A mesh names `torch.distributed` global ranks, one process per rank; the
collectives run over `torch.distributed` process groups of whatever
backend the caller initialized (NCCL on cards, gloo on the CPU).
`checkpoint` saves and loads state dicts in the JAX package's sharded
checkpoint files.
"""
from . import checkpoint
from .checkpoint import load_state_dict, save_state_dict
from .process_mesh import ProcessMesh
from .tp_overlap import (TPInfo, axis_index, gather_columns, out_features,
                         row_parallel_matmul, slice_out_channels)

__all__ = ["checkpoint", "load_state_dict", "save_state_dict",
           "ProcessMesh", "TPInfo", "axis_index", "gather_columns",
           "out_features", "row_parallel_matmul", "slice_out_channels"]
