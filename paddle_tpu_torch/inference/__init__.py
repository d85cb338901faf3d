from .cache import BlockCacheManager, KVCacheExhausted, SequenceTooLong
from .llama_runner import GenerationConfig, LlamaInferenceEngine

__all__ = ["BlockCacheManager", "KVCacheExhausted", "SequenceTooLong",
           "GenerationConfig", "LlamaInferenceEngine"]
