from .cache import BlockCacheManager, KVCacheExhausted, SequenceTooLong
from .llama_runner import GenerationConfig, LlamaInferenceEngine
from .predictor import (Config, DataType, PlaceType, Predictor,
                        PredictorTensor, create_predictor, get_version)
from .prefix_cache import RadixPrefixCache

__all__ = ["BlockCacheManager", "KVCacheExhausted", "SequenceTooLong",
           "GenerationConfig", "LlamaInferenceEngine", "RadixPrefixCache",
           "Config", "DataType", "PlaceType", "Predictor", "PredictorTensor",
           "create_predictor", "get_version"]
