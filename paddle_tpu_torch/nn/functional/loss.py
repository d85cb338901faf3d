"""`cross_entropy` with hard labels, the port of
`paddle_tpu/nn/functional/loss.py:35-61` and `:80-121` as far as the Llama
models need it: a log-softmax and a gather, computed in the logits' own
dtype (as JAX computes it, so bf16 logits give a bf16 loss).

On eager Tensors it is JAX's composition: the op `cross_entropy_hard`
(`(loss, valid)`, on the AMP black list), then the mean as the sum over
the count of valid labels cast to the logits' dtype. On torch tensors
(the `nn.Module` Llama's) it is one plain function."""
from __future__ import annotations

import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...ops._helpers import as_tensor

__all__ = ["cross_entropy"]


def _ce_hard_fn(logits, label, *, axis, ignore_index):
    m = logits.amax(dim=axis, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=axis, keepdim=True)) + m
    logp = logits - lse
    if label.dim() == logp.dim():
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = logp.gather(axis, safe.long().unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros((), dtype=logp.dtype,
                                                   device=logp.device))
    return loss, valid


dispatch.register_op("cross_entropy_hard", _ce_hard_fn, multi_out=True)


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1, name=None):
    """Hard-label cross entropy over the last axis of `input`. Labels equal
    to `ignore_index` add 0; `reduction="mean"` divides the sum by the
    count of the other labels (taken in the logits' dtype). The other
    reductions, soft labels, class weights and label smoothing are not
    ported yet."""
    if reduction != "mean":
        raise NotImplementedError(f"cross_entropy: reduction {reduction!r} "
                                  f"is not ported yet")
    if isinstance(input, Tensor) or isinstance(label, Tensor):
        from ...ops import manipulation

        input, label = as_tensor(input), as_tensor(label)
        loss, valid = dispatch.apply(
            "cross_entropy_hard", [input, label],
            {"axis": int(axis), "ignore_index": int(ignore_index)})
        denom = manipulation.cast(valid, input.dtype).sum()
        return loss.sum() / denom
    loss, valid = _ce_hard_fn(input, label, axis=-1,
                              ignore_index=ignore_index)
    return loss.sum() / valid.to(loss.dtype).sum()
