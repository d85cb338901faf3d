"""Placement types: Shard / Replicate / Partial (the port of
`paddle_tpu/distributed/placement.py`, with its equality, hashing and
predicates).

Analog of the reference `phi/core/distributed/auto_parallel/placement_types.h`
and `paddle.distributed.{Shard,Replicate,Partial}`. A tensor distributed over
an N-dim ProcessMesh carries one placement per mesh dim.
"""
from __future__ import annotations


class ReduceType:
    kRedSum = "sum"
    kRedMax = "max"
    kRedMin = "min"
    kRedProd = "prod"
    kRedAvg = "avg"
    kRedAny = "any"
    kRedAll = "all"


class Placement:
    def is_shard(self, dim=None) -> bool:
        return False

    def is_replicated(self) -> bool:
        return False

    def is_partial(self) -> bool:
        return False


class Replicate(Placement):
    def is_replicated(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")

    def __repr__(self):
        return "Replicate()"


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def get_dim(self) -> int:
        return self.dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Partial(Placement):
    def __init__(self, reduce_type: str = ReduceType.kRedSum):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("Partial", self.reduce_type))

    def __repr__(self):
        return f"Partial(reduce_type={self.reduce_type})"
