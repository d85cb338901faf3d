"""AMP debugging tools: the port of `paddle_tpu/amp/debugging.py`.

Per-op dtype statistics (`collect_operator_stats`, an op observer on
`core.dispatch.add_op_observer`), the NaN/Inf checking toggles
(`enable_tensor_checker` sets `FLAGS_check_nan_inf`) and the
compare-accuracy entry point, which raises as the JAX package's does.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

from ..core import dispatch
from ..framework import flags

__all__ = ["collect_operator_stats", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "enable_tensor_checker",
           "disable_tensor_checker", "TensorCheckerConfig",
           "DebugMode", "compare_accuracy"]


_stats = None
_observer = None

_DTYPE_COLS = ("float16", "bfloat16", "float32", "other")


def _col_of(dt) -> str:
    name = str(dt).replace("torch.", "")
    return name if name in _DTYPE_COLS else "other"


def enable_operator_stats_collection():
    global _stats, _observer
    if _observer is not None:  # idempotent: drop any prior observer first
        dispatch.remove_op_observer(_observer)
        _observer = None
    _stats = defaultdict(lambda: dict.fromkeys(_DTYPE_COLS, 0))

    def obs(op_name, tensors):
        for t in tensors:
            _stats[op_name][_col_of(t._data.dtype)] += 1

    _observer = obs
    dispatch.add_op_observer(obs)


def disable_operator_stats_collection():
    global _stats, _observer
    if _observer is not None:
        dispatch.remove_op_observer(_observer)
        _observer = None
    if _stats:
        print("<{:-^120}>".format(" op list "))
        fmt = "{:<50} {:<15} {:<15} {:<15} {:<15}"
        print(fmt.format("<op_type>", *(f"<{c}>" for c in _DTYPE_COLS)))
        for op, row in sorted(_stats.items()):
            print(fmt.format(op, *(row[c] for c in _DTYPE_COLS)))
        print("<{:-^120}>".format(""))
    _stats = None


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def operator_stats():
    """Programmatic access to the currently collected stats (test hook)."""
    return {k: dict(v) for k, v in (_stats or {}).items()}


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    def __init__(self, enable=False,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


def enable_tensor_checker(config: TensorCheckerConfig):
    if config.enable:
        flags.set_flags({
            "FLAGS_check_nan_inf": True,
            "FLAGS_check_nan_inf_level": 0 if config.debug_mode ==
            DebugMode.CHECK_NAN_INF_AND_ABORT else 1,
        })


def disable_tensor_checker():
    flags.set_flags({"FLAGS_check_nan_inf": False})


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "compare_accuracy requires dumped tensor files; use "
        "collect_operator_stats + enable_tensor_checker instead")
