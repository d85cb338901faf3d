"""paddle_tpu_torch.incubate.distributed — the MoE layer
(`models.moe`)."""
from . import models  # noqa: F401
