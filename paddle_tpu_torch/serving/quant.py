"""Quantized serving: weight-only engine quantization after construction,
the quantization mode a serving run publishes, and the greedy-agreement
yardstick (the port of `paddle_tpu/serving/quant.py`).

`quantize_engine(engine, wbits=8|4)` swaps a built engine's projection
weights, and an untied lm_head, for the `{"q"|"q4", "s"}` dicts the
engine's `_mm` runs through the weight-only gemm kernels (the MLP
engine's `w1` / `w2` likewise). Scales are the
per-output-channel absmax / qmax in f32 — the numbers the JAX package's
`ChannelAbsmaxObserver` calibrates — so the engine constructor's
quantizer (`llama_runner.quantize_weight`) serves both. KV quantization
is a construction-time choice (`kv_bits=8`); `quant_summary` reads both
back for the metrics layer.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..inference.llama_runner import QUANT_KEYS, quantize_weight

__all__ = ["quantize_engine", "quant_summary", "greedy_agreement"]


# the MLP engine's gemm weights ([K, N] each)
_MLP_KEYS = ("w1", "w2")


@torch.no_grad()
def quantize_engine(engine, wbits: int = 8):
    """Weight-only-quantize a built engine IN PLACE; returns it.

    A Llama engine's qkv / o / gate_up / down projections of every layer
    (per-layer, per-output-channel scales) and an untied lm_head, or an
    `MLPLMEngine`'s `w1` / `w2`, become int8 or split-half packed int4.
    The embedding stays in the native dtype, and so does a tied head,
    which is the embedding. `wbits`: 8 or 4 (int4 needs even
    in_features). Raises on an engine whose weights are already
    quantized: re-quantizing quantized values would compound error
    silently."""
    if wbits not in (4, 8):
        raise ValueError(f"wbits must be 4 or 8, got {wbits}")
    params = getattr(engine, "params", None)
    if not isinstance(params, dict) or not ("qkv_w" in params
                                            or "w1" in params):
        raise TypeError(f"{type(engine).__name__}: unrecognized parameter "
                        "layout (expected the Llama projection keys or "
                        "MLP w1/w2)")
    algo = f"int{wbits}"
    new = dict(params)
    if "qkv_w" not in params:
        for key in _MLP_KEYS:
            if isinstance(params[key], dict):
                raise ValueError(f"engine weight {key!r} is already "
                                 "quantized - re-quantizing would "
                                 "compound error")
        for key in _MLP_KEYS:
            new[key] = quantize_weight(params[key], algo)
        engine.params = new
        engine.weight_only = algo
        return engine
    for key in QUANT_KEYS:
        if any(isinstance(w, dict) for w in params[key]):
            raise ValueError(f"engine weight {key!r} is already quantized "
                             "- re-quantizing would compound error")
    for key in QUANT_KEYS:
        new[key] = [quantize_weight(w, algo) for w in params[key]]
    head = params.get("lm_head")
    if head is not None and not isinstance(head, dict):
        new["lm_head"] = quantize_weight(head, algo)    # [H, V] -> [V, H]
    engine.params = new
    engine.weight_only = algo
    return engine


def quant_summary(engine) -> Dict[str, object]:
    """The quantization mode of an engine, for metrics and reports:
    `{"wbits", "kv_bits", "kv_bytes_per_token"}` (16 = unquantized
    weights / native-dtype KV); the defaults for an engine without a
    `quant_info` hook."""
    info = getattr(engine, "quant_info", None)
    if info is None:
        return {"wbits": 16, "kv_bits": 16, "kv_bytes_per_token": None}
    return dict(info())


def greedy_agreement(engine, reference, prompts) -> Dict[str, float]:
    """Teacher-forced greedy top-1 agreement of `engine` (the quantized
    candidate) against `reference` (full precision): each prompt goes
    through ONE `ragged_step` per engine, every position scoring against
    the same committed context. The tie-aware margin is measured on
    `reference`'s logits, so the argument order matters.

    Returns `agreement` (strict argmax match fraction),
    `agreement_tie_aware` (match, or the reference's margin between its
    top-1 and the candidate's pick within twice the position's logit
    perturbation), `max_logit_err`, `mean_logit_err` and `positions`.
    Both engines' pools are used from empty and freed afterwards; each
    prompt must fit one `max_blocks_per_seq` allocation."""
    agree = agree_tie = total = 0
    max_err = err_sum = 0.0
    for pid, prompt in enumerate(prompts):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rows = []
        for eng in (engine, reference):
            seq = 1_000_000 + pid     # out of any live request id space
            eng.manager.allocate(seq, len(prompt))
            try:
                tables = eng.manager.block_table_array([seq])
                n = len(prompt)
                logits = eng.ragged_step(prompt, np.array([n], np.int32),
                                         np.array([n], np.int32), tables)
                logits = logits[:n].cpu().numpy()
            finally:
                # a raising dispatch must not strand the synthetic lease
                eng.manager.free(seq)
            rows.append(logits.astype(np.float64))
        la, lb = rows                        # candidate / reference
        top_a = la.argmax(-1)
        top_b = lb.argmax(-1)
        match = top_a == top_b
        eps = np.abs(la - lb).max(-1)                  # [T] perturbation
        idx = np.arange(la.shape[0])
        margin = lb[idx, top_b] - lb[idx, top_a]
        tie = margin <= 2.0 * eps
        agree += int(match.sum())
        agree_tie += int((match | tie).sum())
        total += la.shape[0]
        max_err = max(max_err, float(np.abs(la - lb).max()))
        err_sum += float(np.abs(la - lb).mean()) * la.shape[0]
    return {
        "agreement": agree / max(total, 1),
        "agreement_tie_aware": agree_tie / max(total, 1),
        "max_logit_err": max_err,
        "mean_logit_err": err_sum / max(total, 1),
        "positions": total,
    }
