from .cache import BlockCacheManager, KVCacheExhausted, SequenceTooLong
from .llama_runner import GenerationConfig, LlamaInferenceEngine
from .prefix_cache import RadixPrefixCache

__all__ = ["BlockCacheManager", "KVCacheExhausted", "SequenceTooLong",
           "GenerationConfig", "LlamaInferenceEngine", "RadixPrefixCache"]
