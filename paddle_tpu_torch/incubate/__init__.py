"""paddle_tpu_torch.incubate — the port's slice of `paddle_tpu/incubate`:
the fused-op functional surface (`incubate.nn.functional`), backed by the
hand-written CUDA kernels under `csrc/`. The MoE layer
(`incubate.distributed`) is not ported yet."""
from . import nn  # noqa: F401

__all__ = ["nn"]
