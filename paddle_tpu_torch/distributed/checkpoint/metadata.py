"""Checkpoint metadata types (the port's copy of
`paddle_tpu/distributed/checkpoint/metadata.py`).

Analog of `python/paddle/distributed/checkpoint/metadata.py`: the global
index that maps every saved local shard (tensor key + global offset) to the
storage file holding it, so a load on a DIFFERENT mesh/placement can find
exactly the bytes each destination shard needs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["LocalTensorMetadata", "LocalTensorIndex", "Metadata"]


@dataclass
class LocalTensorMetadata:
    """The location of a local shard inside its global tensor."""

    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    dtype: str
    global_shape: Tuple[int, ...] = ()


@dataclass(frozen=True)
class LocalTensorIndex:
    """The identity of a local shard."""

    tensor_key: str
    global_offset: Tuple[int, ...]


@dataclass
class Metadata:
    state_dict_metadata: Dict[str, List[LocalTensorMetadata]] = field(
        default_factory=dict)
    storage_metadata: Dict[LocalTensorIndex, str] = field(
        default_factory=dict)
    flat_mapping: Optional[Dict[str, Tuple[str, ...]]] = None
