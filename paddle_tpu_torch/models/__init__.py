"""The Llama models: `llama` (an `nn.Module` over plain tensors, which
training and serving use) and `llama_layers` (the JAX package's Llama in
paddle Layers over eager Tensors)."""
from . import llama_layers
from .llama import LlamaConfig, LlamaForCausalLM, llama_7b_shaped, llama_tiny

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama_7b_shaped",
           "llama_tiny", "llama_layers"]
