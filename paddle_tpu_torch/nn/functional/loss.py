"""`cross_entropy` with hard labels, the port of
`paddle_tpu/nn/functional/loss.py:35-61` and `:80-121` as far as the Llama
model needs it: a log-softmax and a gather, computed in the logits' own
dtype (as JAX computes it, so bf16 logits give a bf16 loss)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Hard-label cross entropy over the last axis of `input`. Labels equal
    to `ignore_index` add 0; `reduction="mean"` divides the sum by the
    count of the other labels (taken in the logits' dtype). The other
    reductions are not ported yet."""
    if reduction != "mean":
        raise NotImplementedError(f"cross_entropy: reduction {reduction!r} "
                                  f"is not ported yet")
    logits = input
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)) + m
    logp = logits - lse
    if label.dim() == logits.dim():
        label = label.squeeze(-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = logp.gather(-1, safe.long().unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, -picked, torch.zeros((), dtype=logits.dtype,
                                                   device=logits.device))
    return loss.sum() / valid.to(logits.dtype).sum()
