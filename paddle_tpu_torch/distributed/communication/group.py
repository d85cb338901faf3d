"""Process groups of the emulated world (the port of
`paddle_tpu/distributed/communication/group.py`; reference
`phi/core/distributed/collective/process_group.h:126`, python
`paddle.distributed.communication.group`).

A group is a set of ranks of the single-controller world
(`process_mesh.emulated_world()`); the eager collectives act on the
stack of its ranks' values (`collective.py`). The JAX package's
`Group.to_jax_mesh` (its 1-D device mesh) has no counterpart.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..process_mesh import emulated_world

__all__ = ["Group", "new_group", "get_group", "destroy_process_group",
           "is_initialized", "get_backend"]

_groups: Dict[int, "Group"] = {}
_next_gid = [0]


def _process_rank() -> int:
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


class Group:
    def __init__(self, ranks: List[int], gid: int, pg_name: str = ""):
        self.ranks = list(ranks)
        self.id = gid
        self.pg_name = pg_name or f"pg_{gid}"

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's rank inside the group (single-controller: the
        process drives every rank, so this is the process rank if it is a
        member, else 0 in a one-process world)."""
        me = _process_rank()
        return self.ranks.index(me) if me in self.ranks else 0

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return True

    @property
    def process_group(self):
        return self

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


def _register(group: Group):
    _groups[group.id] = group


def new_group(ranks: Optional[List[int]] = None, backend=None, timeout=None
              ) -> Group:
    """Create a communication group (reference `dist.new_group`)."""
    if ranks is None:
        ranks = list(range(emulated_world()))
    _next_gid[0] += 1
    g = Group(sorted(ranks), _next_gid[0])
    _register(g)
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    return _groups.get(gid)


def _get_global_group() -> Group:
    g = _groups.get(0)
    if g is None or g.nranks != emulated_world():
        g = _groups[0] = Group(list(range(emulated_world())), 0, "global")
    return g


def destroy_process_group(group: Optional[Group] = None):
    if group is None:
        _groups.clear()
    else:
        _groups.pop(group.id, None)


def is_initialized() -> bool:
    return 0 in _groups


def get_backend(group=None) -> str:
    """The single-controller backend: every rank's value lives in this
    process ("emulated"); the JAX package answers "xla"."""
    return "emulated"
