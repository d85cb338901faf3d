"""Carry weights from the JAX package into the port.

The two packages name and lay out their parameters alike (paddle names,
Linear weights `[in, out]`), so the state exported by
`paddle_tpu.jit.state_arrays` as numpy arrays loads as it is.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_jax_state"]


@torch.no_grad()
def from_jax_state(state: Dict[str, np.ndarray], config: LlamaConfig,
                   device=None,
                   model: Optional[LlamaForCausalLM] = None
                   ) -> LlamaForCausalLM:
    """Build a trainable `LlamaForCausalLM` holding `state` (name -> numpy
    array, e.g. `{k: np.asarray(v) for k, v in
    state_arrays(jax_model).items()}`), or load `state` into `model` in
    place (its device and dtype stay) and return it. Tied embeddings (no
    `lm_head.weight`) and GQA follow from `config`. `device=None` means
    the CUDA card, as everywhere in the port. Every parameter must be
    present with its exact shape."""
    if model is None:
        model = LlamaForCausalLM(config, device=device)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the config: missing "
                       f"{missing}, unexpected {extra}")
    for name, p in params.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return model
