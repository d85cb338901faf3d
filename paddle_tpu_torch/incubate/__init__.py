"""paddle_tpu_torch.incubate — the port's slice of `paddle_tpu/incubate`:
the fused-op functional surface (`incubate.nn.functional`), backed by the
hand-written CUDA kernels under `csrc/`, and the MoE layer
(`incubate.distributed.models.moe`) with its dispatch and gather
kernels."""
from . import distributed, nn  # noqa: F401

__all__ = ["nn", "distributed"]
