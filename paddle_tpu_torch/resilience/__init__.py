"""Resilience: fault injection (`faults`), the rotating verified
`CheckpointManager` and the `StepGuard` that rolls a training run back
to it (the port of `paddle_tpu/resilience/`, but `elastic_train.py`)."""
from . import faults
from .checkpoint_manager import CheckpointManager
from .guard import (NoValidCheckpoint, Preempted, RestartBudgetExceeded,
                    StepGuard)

__all__ = ["faults", "CheckpointManager", "StepGuard",
           "RestartBudgetExceeded", "NoValidCheckpoint", "Preempted"]
