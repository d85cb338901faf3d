"""Activations the Llama model calls: `swiglu`, the plain
`paddle_tpu/ops/activation.py:193-202` (the model's MLP does not reach the
Pallas `bias_act` kernels)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["swiglu"]


def swiglu(x, y=None):
    """`silu(x) * y`; with `y=None`, x is split in two halves along its
    last axis first."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y
