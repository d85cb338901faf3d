"""EngineCore — the model-agnostic serving engine protocol the scheduler
programs against (the port of `paddle_tpu/serving/engine.py`'s protocol).

An engine owns the model weights and a paged KV pool, exposes its
`BlockCacheManager` as `manager`, and serves through `ragged_step` (the
scheduler's plain rounds) and `verify_step` (its speculative rounds); a
draft engine behind `DraftEngineProposer` is driven through `prefill`
and `decode_step`. It may raise from a step: a typed `EngineStepError`
naming lanes fails only those requests; any other exception propagates
out of the scheduler's step.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from ..inference.cache import BlockCacheManager

__all__ = ["EngineCore"]


@runtime_checkable
class EngineCore(Protocol):
    """Structural protocol: `LlamaInferenceEngine` satisfies it as-is."""

    max_batch_size: int
    manager: BlockCacheManager

    def ragged_step(self, tokens: np.ndarray, q_lens: np.ndarray,
                    kv_lens: np.ndarray, block_tables: np.ndarray):
        """ONE step over a packed ragged batch: tokens [T] lane-major
        (lane i owns q_lens[i] consecutive slots, token j at position
        kv_lens[i] - q_lens[i] + j; q_len 0 = empty lane). Returns logits
        [T, V] (a tensor on the engine's device)."""
        ...

    def verify_step(self, tokens: np.ndarray, context_lens: np.ndarray,
                    block_tables: np.ndarray):
        """Speculative verify: tokens [B, S] (pending token + S - 1
        drafts per lane), token i written at position
        `context_lens - S + i` and attending causally up to itself.
        Returns logits [B, S, V]; row i is the distribution for the token
        after tokens[:, i]."""
        ...

    def prefill(self, input_ids: np.ndarray, block_tables: np.ndarray,
                lens: np.ndarray | None = None):
        """Prompts [B, S] (right-padded; `lens` the true lengths) written
        at positions 0..S-1; returns next-token logits [B, V]."""
        ...

    def decode_step(self, tokens: np.ndarray, context_lens: np.ndarray,
                    block_tables: np.ndarray):
        """One token per sequence at position `context_lens - 1`; returns
        logits [B, V]."""
        ...
