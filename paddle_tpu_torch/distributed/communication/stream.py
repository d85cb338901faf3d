"""Stream-ordered collective variants (the port of
`paddle_tpu/distributed/communication/stream.py`; reference
`python/paddle/distributed/communication/stream/`). The card runs the
collectives in stream order already, so these alias the synchronous
implementations."""
from .collective import (all_gather, all_reduce, alltoall,  # noqa: F401
                         alltoall_single, broadcast, recv, reduce,
                         reduce_scatter, scatter, send)

__all__ = ["all_gather", "all_reduce", "alltoall", "alltoall_single",
           "broadcast", "recv", "reduce", "reduce_scatter", "scatter", "send"]
