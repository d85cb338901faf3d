"""paddle_tpu_torch.amp: automatic mixed precision, the port of
`paddle_tpu/amp/`. `auto_cast` (O1 / O2 / OD, bfloat16 by default)
rewrites each op's inputs through `core.dispatch.set_amp_hook`,
`decorate` casts a model for O2 and turns on the optimizer's float32
master weights, and `GradScaler` scales the loss dynamically, skipping a
step whose gradients hold an inf or a NaN."""
from . import debugging  # noqa: F401
from .amp_lists import (AutoMixedPrecisionLists, BLACK_LIST,  # noqa: F401
                        WHITE_LIST, black_list, white_list)
from .auto_cast import (amp_decorate, amp_guard, amp_state,  # noqa: F401
                        auto_cast, decorate, is_bfloat16_supported,
                        is_float16_supported, need_keep_fp32)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate", "GradScaler",
           "AmpScaler", "OptimizerState", "AutoMixedPrecisionLists",
           "is_bfloat16_supported", "is_float16_supported", "debugging",
           "white_list", "black_list"]
