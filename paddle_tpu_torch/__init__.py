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

The eager API: `paddle.Tensor` over one `torch.Tensor`, `to_tensor` and
the creation ops, the elementwise, manipulation, comparison, reduction
and activation ops with paddle's promotion (bound as Tensor methods
under the reference's method names, `tensor_method_names.py`), `paddle.grad`, hooks, `no_grad`,
`autograd.PyLayer` and `jacobian` / `hessian`, seeded draws with the JAX
package's bits (`seed`, `rand`, `randint`), over torch autograd; new
tensors go to the card unless `set_device("cpu")`.
`nn.functional.scaled_dot_product_attention` and `rms_norm` take Tensors
to the same kernels.

The paddle-style model path: `nn.Layer` and its core layers over
`Parameter`s, `optimizer.SGD` / `Momentum` / `Adam` / `AdamW` over them,
`save` / `load` (the JAX package's file format, both ways),
`jit.to_static` (a `torch.export` capture per input signature),
`jit.save` / `jit.load` and `inference.create_predictor`; captured and
loaded programs reach the flash and RMSNorm kernels as custom ops.

Lazy eager mode (`core.lazy_guard()`, `FLAGS_lazy_mode`) records ops and
runs them at a barrier, on the card as CUDA graphs; `amp` is automatic
mixed precision (`auto_cast`, `decorate`, `GradScaler`); and
`models.llama_layers` is the JAX package's Llama written in paddle
Layers.

The rest of the tensor ops: `paddle.linalg` (products, norms, counts,
decompositions, solvers), `paddle.fft` (differentiable transforms over
`torch.fft`), `paddle.signal` (`stft` / `istft`) and the extended
surface (`ops/extended.py`: the stack / split families, the scatters by
index, special functions, seeded draws, in-place forms), all bound as
Tensor methods.
"""
from .framework.dtype import (DType, bfloat16, complex64, complex128,
                              float8_e4m3fn, float8_e5m2, float16, float32,
                              float64, get_default_dtype, int8, int16, int32,
                              int64, set_default_dtype, uint8, uint16)
from .framework.dtype import bool_ as bool
from .framework.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place,
                              device_count, get_device,
                              is_compiled_with_cuda, set_device)
from .framework.flags import get_flags, set_flags
from .framework.random import get_rng_state, seed, set_rng_state
from .framework.dtype import DType as dtype
from .core.tensor import Tensor
from .core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from . import ops
from .ops import *  # noqa: F401,F403
from .ops import linalg
from . import fft, signal
from . import autograd
from .framework.io import load, save
from . import amp, nn, optimizer, jit, regularizer
from . import quantization
from .nn.parameter import ParamAttr, create_parameter
from .convert import from_jax_state, mlp_from_jax_params, moe_from_jax_state
from . import inference
from .inference import LlamaInferenceEngine
from .models import LlamaConfig, LlamaForCausalLM, llama_7b_shaped, llama_tiny
from .serving import (DisaggRouter, FleetHandle, FleetRouter, HandoffError,
                      HandoffState, MLPLMEngine, ReplicaHandle, RequestHandle,
                      ServingFrontend)
from . import distributed
from .distributed import DataParallel

__all__ = ops.__all__ + [
           "DType", "bfloat16", "complex64", "complex128", "float8_e4m3fn",
           "float8_e5m2", "float16", "float32", "float64",
           "get_default_dtype", "int8", "int16", "int32", "int64",
           "set_default_dtype", "uint8", "uint16", "bool", "CPUPlace",
           "CUDAPinnedPlace", "CUDAPlace", "Place", "device_count",
           "get_device", "is_compiled_with_cuda", "set_device", "get_flags",
           "set_flags", "get_rng_state", "seed", "set_rng_state", "Tensor",
           "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled", "autograd", "load", "save", "amp", "nn",
           "optimizer", "jit", "regularizer", "quantization",
           "ParamAttr", "create_parameter", "from_jax_state", "mlp_from_jax_params", "moe_from_jax_state",
           "LlamaInferenceEngine", "LlamaConfig", "LlamaForCausalLM",
           "llama_7b_shaped", "llama_tiny", "MLPLMEngine", "RequestHandle",
           "ServingFrontend", "FleetRouter", "FleetHandle", "ReplicaHandle",
           "DisaggRouter", "HandoffState", "HandoffError", "linalg", "fft",
           "signal", "dtype", "get_cuda_rng_state", "set_cuda_rng_state",
           "LazyGuard", "distributed", "DataParallel"]

# the CUDA-named RNG state calls are the default generator's
get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state


class LazyGuard:
    """A no-op context (`nn/initializer/lazy_init.py`'s guard, which
    defers parameter materialisation): parameters here are made when
    their Layer is built."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _bind_tensor_methods():
    """Bind each reference Tensor-method name that is not yet a `Tensor`
    attribute to the same-named function of this package, or else of its
    `linalg`, `fft` or `signal` namespace (`paddle_tpu/__init__.py:92-117`);
    a name with no such function stays unbound."""
    import sys

    from .tensor_method_names import TENSOR_METHOD_NAMES

    search = [sys.modules[__name__], linalg, fft, signal]
    for name in TENSOR_METHOD_NAMES:
        if hasattr(Tensor, name):
            continue
        for mod in search:
            fn = getattr(mod, name, None)
            if callable(fn) and not isinstance(fn, type):
                setattr(Tensor, name, fn)
                break


_bind_tensor_methods()
