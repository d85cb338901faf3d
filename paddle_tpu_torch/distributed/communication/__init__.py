"""Groups, the eager collectives and the comm watchdog of the
single-controller world (the port of
`paddle_tpu/distributed/communication/`)."""
from . import stream  # noqa: F401
from .collective import *  # noqa: F401,F403
from .group import (Group, destroy_process_group, get_backend,  # noqa: F401
                    get_group, is_initialized, new_group)
from .watchdog import (CollectiveStalled, CommWatchdog,  # noqa: F401
                       watchdog_guard)
