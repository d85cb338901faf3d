from ..inference.kv_migrate import KVMigrationError
from .disagg import DisaggRouter, HandoffError, HandoffState
from .engine import EngineCore, MLPLMEngine
from .fault_tolerance import (AdmissionConfig, EngineStalled, EngineStepError,
                              OverloadController, WatchdogConfig)
from .fleet import FleetHandle, FleetRouter, ReplicaHandle
from .frontend import RequestHandle, ServingFrontend
from .lora import (AdapterError, AdapterPool, AdapterPoolExhausted,
                   AdapterRankError, LoRAEngine, UnknownAdapterError,
                   attach_adapters)
from .metrics import ServingMetrics
from .quant import greedy_agreement, quant_summary, quantize_engine
from .scheduler import Request, RequestStatus, SamplingParams, Scheduler
from .slo import DEFAULT_TENANT, SLOClass, SLOConfig, slo_for_adapters
from .spec import (DraftEngineProposer, NGramProposer, Proposer,
                   SpecDecodeConfig)
from .tp import LockstepError, ShardedEngine, ShardingConfigError, shard_engine

__all__ = ["EngineCore", "MLPLMEngine", "AdmissionConfig", "EngineStalled",
           "EngineStepError", "OverloadController", "WatchdogConfig",
           "RequestHandle", "ServingFrontend", "ServingMetrics", "Request",
           "RequestStatus", "SamplingParams", "Scheduler",
           "greedy_agreement", "quant_summary", "quantize_engine",
           "DEFAULT_TENANT", "SLOClass", "SLOConfig", "slo_for_adapters",
           "DraftEngineProposer", "NGramProposer", "Proposer",
           "SpecDecodeConfig", "AdapterError", "AdapterPool",
           "AdapterPoolExhausted", "AdapterRankError", "LoRAEngine",
           "UnknownAdapterError", "attach_adapters", "KVMigrationError",
           "LockstepError", "ShardedEngine", "ShardingConfigError",
           "shard_engine", "FleetHandle", "FleetRouter", "ReplicaHandle",
           "DisaggRouter", "HandoffError", "HandoffState"]
