"""Sharded checkpointing: the port of `paddle_tpu/distributed/checkpoint/`
(per-shard safetensors files with a crc32 per tensor, a global JSON
index, async save, typed errors), reading and writing the JAX package's
files."""
from .errors import AsyncSaveError, CheckpointCorrupt
from .load_state_dict import load_state_dict, verify_checkpoint
from .metadata import LocalTensorIndex, LocalTensorMetadata, Metadata
from .save_state_dict import save_state_dict

__all__ = ["save_state_dict", "load_state_dict", "verify_checkpoint",
           "Metadata", "LocalTensorMetadata", "LocalTensorIndex",
           "CheckpointCorrupt", "AsyncSaveError"]
