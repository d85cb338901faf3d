"""Typed checkpoint failure classes (the port's copy of
`paddle_tpu/distributed/checkpoint/errors.py`).

The load path used to surface whatever low-level error happened to fire
first (KeyError from a missing index entry, EOFError from a short read,
a bare IOError from a crc mismatch). Callers that implement *policy* —
`resilience.CheckpointManager.latest_valid()` quarantining a torn
directory and falling back to an older one — need a single typed signal
that means "this checkpoint directory is not loadable", distinct from
programmer errors.
"""
from __future__ import annotations

__all__ = ["CheckpointCorrupt", "AsyncSaveError"]


class CheckpointCorrupt(RuntimeError):
    """The checkpoint at ``path`` is torn, truncated, or fails integrity
    verification. ``key``/``file`` identify the first bad tensor/shard."""

    def __init__(self, path: str, reason: str, key: str = "",
                 file: str = ""):
        self.path = path
        self.key = key
        self.file = file
        where = f" (tensor '{key}'" + (f" in {file})" if file else ")") \
            if key else (f" ({file})" if file else "")
        super().__init__(f"corrupt checkpoint at {path}{where}: {reason}")


class AsyncSaveError(RuntimeError):
    """A background checkpoint write failed. Raised at the next
    synchronisation point (`save_state_dict` to the same path, `wait`,
    or a load of that path) on the caller's thread, chained from the
    original exception."""

    def __init__(self, path: str, cause: BaseException):
        self.path = path
        super().__init__(f"async checkpoint save to {path} failed: "
                         f"{cause!r}")
        self.__cause__ = cause
