"""`paddle.distributed.Strategy`: typed config sections for auto-parallel
(the port of `paddle_tpu/distributed/auto_parallel/strategy.py`;
reference `python/paddle/distributed/auto_parallel/strategy.py`, proto
analog `fluid/framework/distributed_strategy.proto:362`)."""
from __future__ import annotations

from typing import Optional

__all__ = ["Strategy"]


class _Section:
    _fields = {}

    def __init__(self, cfg: Optional[dict] = None):
        for k, v in self._fields.items():
            setattr(self, k, v)
        for k, v in (cfg or {}).items():
            if k not in self._fields:
                raise ValueError(
                    f"{type(self).__name__} has no option {k!r}; valid: "
                    f"{sorted(self._fields)}")
            setattr(self, k, v)

    def to_dict(self):
        return {k: getattr(self, k) for k in self._fields}

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()})"


class ShardingConfig(_Section):
    """ZeRO-style optimizer/param sharding over the dp axis
    (reference strategy sharding section / group_sharded stages)."""

    _fields = {"enable": False, "stage": 1, "degree": -1}


class AmpConfig(_Section):
    """bf16-first mixed precision (compute dtype; f32 master weights live
    in the optimizer state)."""

    _fields = {"enable": False, "dtype": "bfloat16", "level": "O2"}


class RecomputeConfig(_Section):
    _fields = {"enable": False}


class PipelineConfig(_Section):
    _fields = {"enable": False, "schedule_mode": "1F1B",
               "micro_batch_size": 1, "accumulate_steps": 1,
               "vpp_degree": 1}


class GradientMergeConfig(_Section):
    _fields = {"enable": False, "k_steps": 1}


class Strategy:
    """Typed strategy for the auto-parallel Engine / DistModel
    (reference `auto_parallel/strategy.py`)."""

    def __init__(self, config: Optional[dict] = None):
        cfg = config or {}
        self.sharding = ShardingConfig(cfg.get("sharding"))
        self.amp = AmpConfig(cfg.get("amp"))
        self.recompute = RecomputeConfig(cfg.get("recompute"))
        self.pipeline = PipelineConfig(cfg.get("pipeline"))
        self.gradient_merge = GradientMergeConfig(cfg.get("gradient_merge"))

    def __repr__(self):
        return (f"Strategy(sharding={self.sharding}, amp={self.amp}, "
                f"recompute={self.recompute}, pipeline={self.pipeline})")
