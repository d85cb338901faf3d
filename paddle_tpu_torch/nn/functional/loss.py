"""The loss functionals: the port of `paddle_tpu/nn/functional/loss.py`.

Each loss is computed as the JAX package computes it, in the input's own
dtype (so bf16 logits give a bf16 loss), under the same op names (the
AMP black list holds the loss ops):
- `cross_entropy`: hard labels through the op `cross_entropy_hard`
  (`(loss, valid)`: a log-softmax, or `log(max(p, 1e-30))` without
  `use_softmax`, a gather, label smoothing towards uniform, and 0 where
  the label is `ignore_index`), soft labels (or float labels of the
  input's shape) through `cross_entropy_soft`; class weights make the
  mean a weighted mean; the hard mean divides the sum by the count of
  valid labels taken in the logits' dtype;
- the reductions are `mean`, `sum` and `none` (`kl_div` also
  `batchmean`);
- `ctc_loss` and `rnnt_loss` run their log-space recursions step by step
  (JAX's `lax.scan`s, masked past each sequence's length), and
  `rnnt_loss`'s FastEmit term changes the gradient, not the value.

Given plain torch tensors (the `nn.Module` Llama's), `cross_entropy`
takes hard labels and computes the same loss as one plain function.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core import dispatch
from ...core.tensor import Tensor
from ...ops import manipulation
from ...ops import math as math_ops
from ...ops import reduction as red_ops
from ...ops._helpers import as_tensor

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "smooth_l1_loss",
           "margin_ranking_loss", "ctc_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "sigmoid_focal_loss", "poisson_nll_loss",
           "multi_label_soft_margin_loss", "soft_margin_loss",
           "gaussian_nll_loss", "dice_loss", "npair_loss",
           "multi_margin_loss", "triplet_margin_with_distance_loss",
           "margin_cross_entropy", "rnnt_loss",
           "adaptive_log_softmax_with_loss", "hsigmoid_loss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _zero_like(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _log_probs(logits, axis, use_softmax):
    if use_softmax:
        m = logits.amax(dim=axis, keepdim=True)
        lse = torch.log(torch.exp(logits - m).sum(dim=axis, keepdim=True)) + m
        return logits - lse
    return torch.log(torch.clamp(logits, min=1e-30))


def _ce_hard_fn(logits, label, *, axis, ignore_index, label_smoothing=0.0,
                use_softmax=True):
    logp = _log_probs(logits, axis, use_softmax)
    if label.dim() == logp.dim():
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = logp.gather(axis, safe.long().unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        # smooth towards uniform: -(1-e)*logp[y] - e/K * sum(logp)
        k = logits.shape[axis]
        loss = -(1.0 - label_smoothing) * picked \
            - (label_smoothing / k) * logp.sum(dim=axis)
    else:
        loss = -picked
    return torch.where(valid, loss, _zero_like(loss)), valid


def _ce_soft_fn(logits, label, *, axis, use_softmax):
    return -(label * _log_probs(logits, axis, use_softmax)).sum(dim=axis)


dispatch.register_op("cross_entropy_hard", _ce_hard_fn, multi_out=True)
dispatch.register_op("cross_entropy_soft", _ce_soft_fn)


def _class_weights(w, lbl, valid):
    """The weight of each valid label (0 where ignored)."""
    safe = manipulation.where(valid, lbl,
                              manipulation.cast(valid, lbl.dtype) * 0)
    cw = manipulation.gather(w, manipulation.reshape(safe, [-1]))
    return manipulation.reshape(cw, lbl.shape) \
        * manipulation.cast(valid, w.dtype)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    if not isinstance(input, Tensor) and not isinstance(label, Tensor) \
            and weight is None and not soft_label:
        loss, valid = _ce_hard_fn(input, label, axis=axis,
                                  ignore_index=ignore_index,
                                  label_smoothing=float(label_smoothing),
                                  use_softmax=use_softmax)
        if reduction == "mean":
            return loss.sum() / valid.to(loss.dtype).sum()
        return loss.sum() if reduction == "sum" else loss
    input, label = as_tensor(input), as_tensor(label)
    if soft_label or (label.dtype.is_floating_point
                      and label.shape == input.shape):
        loss = dispatch.apply("cross_entropy_soft", [input, label],
                              {"axis": int(axis),
                               "use_softmax": bool(use_softmax)})
        if weight is not None:
            cw = (label * as_tensor(weight)).sum(axis)
            loss = loss * cw
            if reduction == "mean":
                return loss.sum() / cw.sum()
        return _reduce(loss, reduction)
    loss, valid = dispatch.apply(
        "cross_entropy_hard", [input, label],
        {"axis": int(axis), "ignore_index": int(ignore_index),
         "label_smoothing": float(label_smoothing),
         "use_softmax": bool(use_softmax)})
    if weight is not None:
        lbl = label
        if lbl.ndim == input.ndim:
            lbl = lbl.squeeze(axis)
        cw = _class_weights(as_tensor(weight), lbl, valid)
        loss = loss * cw
        if reduction == "mean":
            return loss.sum() / cw.sum()
        return _reduce(loss, reduction)
    if reduction == "mean":
        return loss.sum() / manipulation.cast(valid, input.dtype).sum()
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    from ...ops import activation

    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = manipulation.unsqueeze(loss, axis)
    if return_softmax:
        return loss, activation.softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    input, label = as_tensor(input), as_tensor(label)
    return _reduce((input - label) * (input - label), reduction)


def square_error_cost(input, label):
    input, label = as_tensor(input), as_tensor(label)
    return (input - label) * (input - label)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = as_tensor(input), as_tensor(label)
    return _reduce((input - label).abs(), reduction)


def _nll_fn(logp, label, *, ignore_index):
    # logp: [N, C, ...]; label: [N, ...]
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    picked = logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    return torch.where(valid, -picked, _zero_like(logp)), valid


dispatch.register_op("nll_loss", _nll_fn, multi_out=True)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    input, label = as_tensor(input), as_tensor(label)
    loss, valid = dispatch.apply("nll_loss", [input, label],
                                 {"ignore_index": int(ignore_index)})
    if weight is not None:
        cw = _class_weights(as_tensor(weight), label, valid)
        loss = loss * cw
        if reduction == "mean":
            return loss.sum() / cw.sum()
        return _reduce(loss, reduction)
    if reduction == "mean":
        return loss.sum() / manipulation.cast(valid, input.dtype).sum()
    return _reduce(loss, reduction)


def _bce_fn(x, label, epsilon=1e-12):
    x = torch.clamp(x, epsilon, 1.0 - epsilon)
    return -(label * torch.log(x) + (1 - label) * torch.log(1 - x))


dispatch.register_op("bce", _bce_fn)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    loss = dispatch.apply("bce", [as_tensor(input), as_tensor(label)])
    if weight is not None:
        loss = loss * as_tensor(weight)
    return _reduce(loss, reduction)


def _bce_logits_fn(x, label, pos_weight=None):
    # numerically stable: max(x, 0) - x*y + log(1 + exp(-|x|))
    neg_abs = -torch.abs(x)
    if pos_weight is not None:
        # (1-y)x + lw*(log(1+exp(-|x|)) + max(-x, 0)), lw = (pw-1)y + 1
        log_weight = (pos_weight - 1) * label + 1
        return (1 - label) * x + log_weight * (
            torch.log1p(torch.exp(neg_abs)) + torch.clamp(-x, min=0))
    return torch.clamp(x, min=0) - x * label + torch.log1p(torch.exp(neg_abs))


dispatch.register_op("bce_logits", lambda x, label: _bce_logits_fn(x, label))
dispatch.register_op("bce_logits_pw", _bce_logits_fn)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    logit, label = as_tensor(logit), as_tensor(label)
    if pos_weight is not None:
        loss = dispatch.apply("bce_logits_pw",
                              [logit, label, as_tensor(pos_weight)])
    else:
        loss = dispatch.apply("bce_logits", [logit, label])
    if weight is not None:
        loss = loss * as_tensor(weight)
    return _reduce(loss, reduction)


def _kl_fn(x, target, *, log_target):
    if log_target:
        return torch.exp(target) * (target - x)
    out = target * (torch.log(torch.clamp(target, min=1e-30)) - x)
    return torch.where(target > 0, out, _zero_like(out))


dispatch.register_op("kl_div", _kl_fn)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    loss = dispatch.apply("kl_div", [as_tensor(input), as_tensor(label)],
                          {"log_target": bool(log_target)})
    if reduction == "batchmean":
        return loss.sum() / loss.shape[0]
    return _reduce(loss, reduction)


def _smooth_l1_fn(x, label, *, delta):
    d = torch.abs(x - label)
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


dispatch.register_op("smooth_l1", _smooth_l1_fn)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    loss = dispatch.apply("smooth_l1", [as_tensor(input), as_tensor(label)],
                          {"delta": float(delta)})
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = as_tensor(input), as_tensor(other), as_tensor(label)
    loss = math_ops.maximum(-label * (input - other) + margin, 0.0)
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = as_tensor(input), as_tensor(label)
    loss = manipulation.where(label == 1.0, input,
                              math_ops.maximum(margin - input, 0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    from .common import cosine_similarity

    sim = cosine_similarity(as_tensor(input1), as_tensor(input2), axis=-1)
    label = as_tensor(label)
    loss = manipulation.where(label == 1, 1.0 - sim,
                              math_ops.maximum(sim - margin, 0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = as_tensor(input), as_tensor(positive), as_tensor(negative)

    def pdist(x, y):
        return math_ops.pow(red_ops.sum(math_ops.pow(
            (x - y).abs() + epsilon, p), axis=-1), 1.0 / p)

    d_pos = pdist(a, pos)
    d_neg = pdist(a, neg)
    if swap:
        d_neg = math_ops.minimum(d_neg, pdist(pos, neg))
    loss = math_ops.maximum(d_pos - d_neg + margin, 0.0)
    return _reduce(loss, reduction)


dispatch.register_op("log_loss", lambda x, y, *, epsilon: -y * torch.log(
    x + epsilon) - (1 - y) * torch.log(1 - x + epsilon))


def log_loss(input, label, epsilon=1e-4, name=None):
    return dispatch.apply("log_loss", [as_tensor(input), as_tensor(label)],
                          {"epsilon": float(epsilon)})


def _focal_fn(logit, label, normalizer, *, alpha, gamma):
    p = torch.sigmoid(logit)
    ce = _bce_logits_fn(logit, label)
    p_t = p * label + (1 - p) * (1 - label)
    alpha_t = alpha * label + (1 - alpha) * (1 - label)
    loss = alpha_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return loss


dispatch.register_op("sigmoid_focal_loss", lambda logit, label, **kw:
                     _focal_fn(logit, label, None, **kw))
dispatch.register_op("sigmoid_focal_loss_norm", _focal_fn)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    attrs = {"alpha": float(alpha), "gamma": float(gamma)}
    if normalizer is not None:
        loss = dispatch.apply("sigmoid_focal_loss_norm",
                              [as_tensor(logit), as_tensor(label),
                               as_tensor(normalizer)], attrs)
    else:
        loss = dispatch.apply("sigmoid_focal_loss",
                              [as_tensor(logit), as_tensor(label)], attrs)
    return _reduce(loss, reduction)


def _poisson_nll(x, y, *, log_input, full, epsilon):
    if log_input:
        loss = torch.exp(x) - y * x
    else:
        loss = x - y * torch.log(x + epsilon)
    if full:
        stirling = y * torch.log(y) - y + 0.5 * torch.log(2 * np.pi * y)
        loss = loss + torch.where(y > 1, stirling, _zero_like(loss))
    return loss


dispatch.register_op("poisson_nll", _poisson_nll)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    loss = dispatch.apply("poisson_nll", [as_tensor(input), as_tensor(label)],
                          {"log_input": bool(log_input), "full": bool(full),
                           "epsilon": float(epsilon)})
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    input, label = as_tensor(input), as_tensor(label)
    return _reduce(math_ops.log1p(math_ops.exp(-label * input)), reduction)


dispatch.register_op("ml_soft_margin", lambda x, y: -(
    y * F.logsigmoid(x) + (1 - y) * F.logsigmoid(-x)))


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    loss = dispatch.apply("ml_soft_margin", [as_tensor(input),
                                             as_tensor(label)])
    if weight is not None:
        loss = loss * as_tensor(weight)
    return _reduce(loss.mean(axis=-1), reduction)


def _gaussian_nll(x, y, var, *, full, epsilon):
    var = torch.clamp(var, min=epsilon)
    loss = 0.5 * (torch.log(var) + (x - y) ** 2 / var)
    if full:
        # JAX adds a numpy float64 constant, which (not weakly typed under
        # x64) promotes the loss to float64
        loss = loss.to(torch.promote_types(loss.dtype, torch.float64)) \
            + 0.5 * math.log(2 * math.pi)
    return loss


dispatch.register_op("gaussian_nll", _gaussian_nll)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    loss = dispatch.apply("gaussian_nll", [as_tensor(input), as_tensor(label),
                                           as_tensor(variance)],
                          {"full": bool(full), "epsilon": float(epsilon)})
    return _reduce(loss, reduction)


def _ctc_fn(logp, labels, in_len, lbl_len, *, blank):
    """CTC's forward algorithm in log space over [T, B, C] log-probs and
    [B, S] labels, step by step over time (`lax.scan` in JAX)."""
    T, B, _ = logp.shape
    S = labels.shape[1]
    dev = logp.device
    # the extended sequence: [blank, l1, blank, l2, ..., blank]
    ext = torch.full((B, 2 * S + 1), blank, dtype=labels.dtype, device=dev)
    ext[:, 1::2] = labels
    ext_len = 2 * lbl_len + 1
    neg_inf = torch.full((), -1e30, dtype=logp.dtype, device=dev)
    first_lbl = logp[0].gather(1, ext[:, 1:2].long()).squeeze(1)
    alpha = torch.cat([logp[0, :, blank:blank + 1],
                       torch.where(lbl_len > 0, first_lbl, neg_inf)[:, None],
                       neg_inf.expand(B, 2 * S - 1)], dim=1)
    same_as_prev2 = torch.cat([torch.ones((B, 2), dtype=torch.bool,
                                          device=dev),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    ext_i = ext.long()
    for t in range(1, T):
        prev1 = torch.cat([neg_inf.expand(B, 1), alpha[:, :-1]], 1)
        prev2 = torch.cat([neg_inf.expand(B, 2), alpha[:, :-2]], 1)
        prev2 = torch.where(same_as_prev2, neg_inf, prev2)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new_alpha = merged + logp[t].gather(1, ext_i)
        alpha = torch.where((t < in_len)[:, None], new_alpha, alpha)
    idx_last = (ext_len - 1).long()
    idx_last2 = torch.clamp(ext_len - 2, min=0).long()
    a1 = alpha.gather(1, idx_last[:, None]).squeeze(1)
    a2 = alpha.gather(1, idx_last2[:, None]).squeeze(1)
    return -torch.logaddexp(a1, a2)


dispatch.register_op("ctc_loss", _ctc_fn)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    label_lengths = as_tensor(label_lengths)
    loss = dispatch.apply("ctc_loss", [as_tensor(log_probs), as_tensor(labels),
                                       as_tensor(input_lengths),
                                       label_lengths], {"blank": int(blank)})
    if reduction == "mean":
        return (loss / manipulation.cast(label_lengths,
                                         loss.dtype).clip(1)).mean()
    return _reduce(loss, reduction)


def _dice_fn(x, y, *, eps):
    onehot = F.one_hot(y[..., 0].long(), x.shape[-1]).to(x.dtype)
    axes = tuple(range(1, x.dim()))
    inter = torch.sum(x * onehot, dim=axes)
    union = torch.sum(x, dim=axes) + torch.sum(onehot, dim=axes)
    return torch.mean(1.0 - (2.0 * inter + eps) / (union + eps))


dispatch.register_op("dice_loss", _dice_fn)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2|X∩Y| / (|X|+|Y|) per sample, averaged: `input` [N, ..., C]
    probabilities, `label` [N, ..., 1] class ids."""
    return dispatch.apply("dice_loss", [as_tensor(input), as_tensor(label)],
                          {"eps": float(epsilon)})


def _npair_fn(a, p, y, *, l2):
    y = y.reshape(-1).to(torch.float32)
    same = (y[:, None] == y[None, :]).to(a.dtype)
    tgt = same / torch.sum(same, dim=1, keepdim=True)
    logits = a @ p.T
    lse = torch.logsumexp(logits, dim=1, keepdim=True)
    xent = torch.mean(torch.sum(tgt * (lse - logits), dim=1))
    reg = l2 * 0.25 * (torch.mean(torch.sum(a * a, dim=1))
                       + torch.mean(torch.sum(p * p, dim=1)))
    return xent + reg


dispatch.register_op("npair_loss", _npair_fn)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """The improved-embedding N-pair loss."""
    return dispatch.apply("npair_loss", [as_tensor(anchor),
                                         as_tensor(positive),
                                         as_tensor(labels)],
                          {"l2": float(l2_reg)})


def _multi_margin_fn(x, y, w, *, p, margin, has_w):
    n, c = x.shape
    rows = torch.arange(n, device=x.device)
    y = y.long()
    target = x[rows, y]
    m = torch.clamp(margin - target[:, None] + x, min=0.0) ** p
    if has_w:
        m = m * w[y][:, None]
    m = m.index_put((rows, y), _zero_like(m))
    return torch.sum(m, dim=1) / c


dispatch.register_op("multi_margin_loss", _multi_margin_fn)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    input = as_tensor(input)
    w = as_tensor(weight) if weight is not None else Tensor._wrap(
        torch.zeros((1,), dtype=torch.float32, device=input._data.device))
    loss = dispatch.apply("multi_margin_loss", [input, as_tensor(label), w],
                          {"p": int(p), "margin": float(margin),
                           "has_w": weight is not None})
    return _reduce(loss, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet loss with a distance callable (default
    `pairwise_distance` with p = 2)."""
    from .common import pairwise_distance

    d = distance_function if distance_function is not None else \
        (lambda a, b: pairwise_distance(a, b, p=2.0))
    input, positive, negative = (as_tensor(input), as_tensor(positive),
                                 as_tensor(negative))
    dp = d(input, positive)
    dn = d(input, negative)
    if swap:
        dn = math_ops.minimum(dn, d(positive, negative))
    zero = Tensor._wrap(torch.zeros((), dtype=torch.float32,
                                    device=input._data.device))
    return _reduce(math_ops.maximum(dp - dn + margin, zero), reduction)


def _margin_ce_fn(x, y, *, m1, m2, m3, s):
    rows = torch.arange(x.shape[0], device=x.device)
    y = y.long()
    cos_t = torch.clamp(x[rows, y], -1.0, 1.0)
    adj = torch.cos(m1 * torch.arccos(cos_t) + m2) - m3
    z = x.index_put((rows, y), adj) * s
    logp = torch.log_softmax(z, dim=-1)
    return -logp[rows, y], torch.softmax(z, dim=-1)


dispatch.register_op("margin_cross_entropy", _margin_ce_fn, multi_out=True)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """The ArcFace-family margin softmax on one device: the target logit
    becomes cos(m1 * theta + m2) - m3, then a scaled cross entropy."""
    loss, softmax = dispatch.apply(
        "margin_cross_entropy", [as_tensor(logits), as_tensor(label)],
        {"m1": float(margin1), "m2": float(margin2), "m3": float(margin3),
         "s": float(scale)})
    loss = _reduce(loss, reduction)
    return (loss, softmax) if return_softmax else loss


def _rnnt_fn(x, y, t_lens, u_lens, *, blank, fastemit_lambda):
    """The RNN-Transducer loss: the alpha lattice over (T, U) in log space,
    row by row in t and cell by cell in u (JAX's nested scans)."""
    b, t_max, u1, _ = x.shape
    dev = x.device
    logp = torch.log_softmax(x.to(torch.float32), dim=-1)
    blank_lp_full = logp[..., blank]                        # [B, T, U+1]
    yexp = y[:, None, :].expand(b, t_max, u1 - 1).long()
    lab_lp = logp[:, :, :-1, :].gather(-1, yexp[..., None])[..., 0]
    neg_inf = torch.full((), -1e30, dtype=torch.float32, device=dev)
    zeros = torch.zeros((b,), dtype=torch.float32, device=dev)

    def lattice(blank_lp):
        cols, carry = [], zeros
        for u in range(u1):
            carry = carry + lab_lp[:, 0, u - 1] if u > 0 else zeros
            cols.append(carry)
        alpha = torch.stack(cols, 1)                        # [B, U+1]
        for t in range(1, t_max):
            from_blank = alpha + blank_lp[:, t - 1]
            cols, carry = [], neg_inf.expand(b)
            for u in range(u1):
                lab = carry + lab_lp[:, t, u - 1] if u > 0 \
                    else neg_inf.expand(b)
                carry = torch.logaddexp(from_blank[:, u], lab)
                cols.append(carry)
            alpha = torch.where((t < t_lens)[:, None], torch.stack(cols, 1),
                                alpha)
        rows = torch.arange(b, device=dev)
        u_idx = u_lens.long()
        return -(alpha[rows, u_idx]
                 + blank_lp[rows, (t_lens - 1).long(), u_idx])

    loss = lattice(blank_lp_full)
    if fastemit_lambda:
        # FastEmit: the label-emission gradient scaled by (1 + lambda), the
        # value unchanged (a zero-valued carrier over constant blanks)
        fe = lattice(blank_lp_full.detach())
        loss = loss + fastemit_lambda * (fe - fe.detach())
    return loss


dispatch.register_op("rnnt_loss", _rnnt_fn)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss over [B, T, U+1, V] logits and [B, U] labels."""
    loss = dispatch.apply("rnnt_loss", [as_tensor(input), as_tensor(label),
                                        as_tensor(input_lengths),
                                        as_tensor(label_lengths)],
                          {"blank": int(blank),
                           "fastemit_lambda": float(fastemit_lambda)})
    return _reduce(loss, reduction)


def _adaptive_lsm_fn(x, y, hw, hb, *arrays, cutoffs, has_bias):
    head_logits = x @ hw
    if has_bias:
        head_logits = head_logits + hb
    head_logp = torch.log_softmax(head_logits, dim=-1)
    shortlist = y < cutoffs[0]
    safe_head_y = torch.where(shortlist, y, torch.zeros_like(y)).long()
    out = torch.where(shortlist, head_logp.gather(1, safe_head_y[:, None])
                      [:, 0], _zero_like(head_logp))
    low = cutoffs[0]
    for i in range(len(arrays) // 2):
        high = cutoffs[i + 1]
        proj, cls_w = arrays[2 * i], arrays[2 * i + 1]
        in_cluster = (y >= low) & (y < high)
        tail_logp = torch.log_softmax((x @ proj) @ cls_w, dim=-1)
        rel = torch.clamp(y - low, 0, high - low - 1).long()
        contrib = head_logp[:, cutoffs[0] + i] \
            + tail_logp.gather(1, rel[:, None])[:, 0]
        out = torch.where(in_cluster, contrib, out)
        low = high
    return out, -torch.mean(out)


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax: the frequent classes in the head, the rare ones in
    projected tail clusters. Returns (each sample's target log-prob, the
    mean loss); op `adaptive_lsm_<clusters>`."""
    input, label = as_tensor(input), as_tensor(label)
    opname = f"adaptive_lsm_{len(tail_weights)}"
    if opname not in dispatch.op_registry():
        dispatch.register_op(opname, _adaptive_lsm_fn, multi_out=True)
    hb = as_tensor(head_bias) if head_bias is not None else Tensor._wrap(
        torch.zeros((1,), dtype=torch.float32, device=input._data.device))
    flat_tails = []
    for proj, cls_w in tail_weights:
        flat_tails += [as_tensor(proj), as_tensor(cls_w)]
    out, loss = dispatch.apply(
        opname, [input, label, as_tensor(head_weight), hb] + flat_tails,
        {"cutoffs": tuple(int(c) for c in cutoffs),
         "has_bias": head_bias is not None})
    return out, loss


def _hsigmoid_fn(x, y, w, b, table, codes, *, has_bias):
    y = y.long()
    rows = table[y]                                   # [N, depth]
    bits = codes[y].to(torch.float32)
    valid = rows >= 0
    safe = torch.clamp(rows, min=0).long()
    logits = torch.einsum("nd,nkd->nk", x, w[safe])
    if has_bias:
        logits = logits + (b[safe][..., 0] if b.dim() == 2 else b[safe])
    # BCE against the path-code bit (the reference's matrix_bit_code sum)
    per = torch.clamp(logits, min=0) - logits * bits \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    per = torch.where(valid, per, _zero_like(per))
    return torch.sum(per, dim=1, keepdim=True)


dispatch.register_op("hsigmoid_loss", _hsigmoid_fn)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree (class c
    is leaf c + C, internal node i uses weight row i - 1), or the tree of
    `path_table` / `path_code`."""
    input = as_tensor(input)
    dev = input._data.device
    if path_table is None:
        depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
        table = np.full((num_classes, depth), -1, np.int32)
        code = np.zeros((num_classes, depth), np.int32)
        for c in range(num_classes):
            node, path = c + num_classes, []
            while node > 1:
                path.append((node // 2, node % 2))
                node //= 2
            for d, (parent, bit) in enumerate(reversed(path)):
                if d < depth:
                    table[c, d] = parent - 1
                    code[c, d] = bit
        path_table = Tensor._wrap(torch.as_tensor(table, device=dev))
        path_code = Tensor._wrap(torch.as_tensor(code, device=dev))
    b = as_tensor(bias) if bias is not None else Tensor._wrap(
        torch.zeros((1,), dtype=torch.float32, device=dev))
    return dispatch.apply(
        "hsigmoid_loss", [input, as_tensor(label), as_tensor(weight), b,
                          as_tensor(path_table), as_tensor(path_code)],
        {"has_bias": bias is not None})
