from .engine import EngineCore
from .fault_tolerance import EngineStalled, EngineStepError
from .frontend import RequestHandle, ServingFrontend
from .metrics import ServingMetrics
from .quant import greedy_agreement, quant_summary, quantize_engine
from .scheduler import Request, RequestStatus, SamplingParams, Scheduler
from .spec import (DraftEngineProposer, NGramProposer, Proposer,
                   SpecDecodeConfig)

__all__ = ["EngineCore", "EngineStalled", "EngineStepError",
           "RequestHandle", "ServingFrontend", "ServingMetrics", "Request",
           "RequestStatus", "SamplingParams", "Scheduler",
           "greedy_agreement", "quant_summary", "quantize_engine",
           "DraftEngineProposer", "NGramProposer", "Proposer",
           "SpecDecodeConfig"]
