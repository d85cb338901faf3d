"""Resilience: fault injection (`faults`), the rotating verified
`CheckpointManager`, the `StepGuard` that rolls a training run back to
it, and the `ElasticTrainSupervisor` that re-forms a training run's
world around lost pods (the port of `paddle_tpu/resilience/`)."""
from . import faults
from .checkpoint_manager import CheckpointManager
from .elastic_train import (CollectiveAborted, CollectiveStalled,
                            ElasticTrainSupervisor, EmulatedTrainable,
                            QuorumLost, ReformBudgetExceeded, WorldChanged,
                            make_emulated_trainable)
from .guard import (NoValidCheckpoint, Preempted, RestartBudgetExceeded,
                    StepGuard)

__all__ = ["CheckpointManager", "StepGuard", "RestartBudgetExceeded",
           "NoValidCheckpoint", "Preempted", "faults",
           "ElasticTrainSupervisor", "EmulatedTrainable",
           "make_emulated_trainable", "WorldChanged", "CollectiveAborted",
           "CollectiveStalled", "QuorumLost", "ReformBudgetExceeded"]
