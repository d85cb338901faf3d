"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper.

It serves the Llama model through the ragged paged-KV engine
(`ServingFrontend` -> `Scheduler` -> `LlamaInferenceEngine.ragged_step`,
or `verify_step` with speculative decoding, `serving.SpecDecodeConfig`;
the prefix cache, tenant SLO classes, overload shedding and the engine
watchdog are frontend options; `MLPLMEngine` is the tiny second engine;
`FleetRouter` and `DisaggRouter` put several frontends behind one
router, with relocation on a replica's death and prefill -> decode
handoffs of KV sessions),
generates with `LlamaInferenceEngine.generate` (`prefill` +
`decode_step`), and trains it (`loss, logits = model(ids, labels=labels)`,
`loss.backward()`, `paddle_tpu_torch.optimizer.AdamW.step()`), with
hand-written CUDA kernels under `csrc/` for the paged attention, the
weight-only gemms, flash attention and RMSNorm. Entry points run on the
CUDA card unless the caller passes `device="cpu"`. The package imports
neither jax nor paddle_tpu.
"""
from .convert import from_jax_state, mlp_from_jax_params, moe_from_jax_state
from .inference import LlamaInferenceEngine
from .models import LlamaConfig, LlamaForCausalLM, llama_7b_shaped, llama_tiny
from .serving import (DisaggRouter, FleetHandle, FleetRouter, HandoffError,
                      HandoffState, MLPLMEngine, ReplicaHandle, RequestHandle,
                      ServingFrontend)

__all__ = ["from_jax_state", "mlp_from_jax_params", "moe_from_jax_state",
           "LlamaInferenceEngine", "LlamaConfig", "LlamaForCausalLM",
           "llama_7b_shaped", "llama_tiny", "MLPLMEngine", "RequestHandle",
           "ServingFrontend", "FleetRouter", "FleetHandle", "ReplicaHandle",
           "DisaggRouter", "HandoffState", "HandoffError"]
