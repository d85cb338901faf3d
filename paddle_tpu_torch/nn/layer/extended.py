"""The rest of `paddle.nn`'s layers: the port of
`paddle_tpu/nn/layer/extended.py` (shape and padding layers, the unpool
and fractional pools, the loss heads, `BeamSearchDecoder` and
`dynamic_decode`). Beam search expands beams with batched tensor ops and
steps in a host loop, as the JAX package does."""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor
from .. import functional as F
from .layers import Layer

__all__ = ["Unflatten", "ZeroPad1D", "ZeroPad3D", "Softmax2D",
           "PairwiseDistance", "FeatureAlphaDropout", "MaxUnPool1D",
           "MaxUnPool3D", "FractionalMaxPool2D", "FractionalMaxPool3D",
           "MultiMarginLoss", "TripletMarginWithDistanceLoss", "RNNTLoss",
           "HSigmoidLoss", "AdaptiveLogSoftmaxWithLoss",
           "BeamSearchDecoder", "dynamic_decode"]


class Unflatten(Layer):
    """Expand one dim into a shape (reference common.py:Unflatten)."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        from ...ops.extended import unflatten

        return unflatten(x, self.axis, self.shape)


class ZeroPad1D(Layer):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format=self.data_format)


class ZeroPad3D(Layer):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__()
        self.padding = padding
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode="constant", value=0.0,
                     data_format=self.data_format)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW (reference
    activation.py:Softmax2D)."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3D/4D input, got {x.ndim}D")
        return F.softmax(x, axis=-3)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, training=self.training)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.cfg = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self.cfg
        return F.max_unpool1d(x, indices, k, s, p, df, osz)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.cfg = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self.cfg
        return F.max_unpool3d(x, indices, k, s, p, df, osz)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.cfg = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        o, k, u, m = self.cfg
        return F.fractional_max_pool2d(x, o, k, u, m)


class FractionalMaxPool3D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.cfg = (output_size, kernel_size, random_u, return_mask)

    def forward(self, x):
        o, k, u, m = self.cfg
        return F.fractional_max_pool3d(x, o, k, u, m)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self.p, self.margin, self.weight = p, margin, weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, self.fastemit_lambda, self.reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid head holding the internal-node parameters
    (reference loss.py:HSigmoidLoss)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=None if bias_attr in (None, True)
            else bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax head (reference loss.py:AdaptiveLogSoftmaxWithLoss):
    head over [cutoff0 + n_clusters], projected tail clusters with
    div_value^i reduced dims."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if not cutoffs or cutoffs != sorted(set(cutoffs)) or \
                cutoffs[-1] > n_classes:
            raise ValueError(f"invalid cutoffs {cutoffs}")
        if cutoffs[-1] != n_classes:
            cutoffs = cutoffs + [n_classes]
        self.cutoffs = cutoffs
        self.n_clusters = len(cutoffs) - 1
        head_size = cutoffs[0] + self.n_clusters
        self.head_weight = self.create_parameter([in_features, head_size])
        self.head_bias = self.create_parameter([head_size], is_bias=True) \
            if head_bias else None
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = cutoffs[i + 1] - cutoffs[i]
            proj = self.create_parameter([in_features, hsz])
            cls_w = self.create_parameter([hsz, osz])
            setattr(self, f"tail_proj_{i}", proj)
            setattr(self, f"tail_cls_{i}", cls_w)
            self.tail_weights.append((proj, cls_w))

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            self.head_bias)

    def log_prob(self, input):
        x = input._data if isinstance(input, Tensor) \
            else torch.as_tensor(np.asarray(input))
        with torch.no_grad():
            head = x @ self.head_weight._data
            if self.head_bias is not None:
                head = head + self.head_bias._data
            head_lp = torch.log_softmax(head, dim=-1)
            parts = [head_lp[:, :self.cutoffs[0]]]
            for i, (proj, cls_w) in enumerate(self.tail_weights):
                tail_lp = torch.log_softmax((x @ proj._data) @ cls_w._data,
                                            dim=-1)
                parts.append(head_lp[:, self.cutoffs[0] + i:self.cutoffs[0]
                                     + i + 1] + tail_lp)
            return Tensor._wrap(torch.cat(parts, dim=-1))

    def predict(self, input):
        from ...ops.reduction import argmax

        return argmax(self.log_prob(input), axis=-1)


class BeamSearchDecoder:
    """Beam-search decoder over an RNN cell (reference
    rnn.py:BeamSearchDecoder). Batched beam expansion in array ops; the
    step loop lives in `dynamic_decode` (host loop — generation is
    eager/latency-bound, matching the reference's dynamic control flow)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        states = initial_cell_states
        probe = states[0] if isinstance(states, (list, tuple)) else states
        batch = probe._data.shape[0] if isinstance(probe, Tensor) else \
            probe.shape[0]
        w = self.beam_size

        def tile(s):
            a = s._data if isinstance(s, Tensor) else s
            return Tensor._wrap(torch.repeat_interleave(a.detach(), w, dim=0))

        states = [tile(s) for s in states] if isinstance(
            states, (list, tuple)) else tile(states)
        ids = Tensor(np.full((batch * w,), self.start_token, np.int64),
                     stop_gradient=True)
        # beam 0 active, others -inf so step 1 expands from one beam
        lp = np.full((batch, w), -1e9, np.float32)
        lp[:, 0] = 0.0
        finished = np.zeros((batch * w,), bool)
        return ids, states, Tensor(lp.reshape(-1), stop_gradient=True), \
            Tensor(finished, stop_gradient=True)

    def step(self, inputs, states, log_probs, finished):
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        out, new_states = self.cell(emb, states)
        logits = self.output_fn(out) if self.output_fn else out
        logits = logits._data if isinstance(logits, Tensor) else logits
        v = logits.shape[-1]
        w = self.beam_size
        bw = logits.shape[0]
        b = bw // w
        logits = logits.detach()
        dev = logits.device
        step_lp = torch.log_softmax(logits.float(), dim=-1)
        fin = finished._data.to(dev)
        # finished beams only extend with end_token at logprob 0
        frozen = torch.full((bw, v), -1e9, device=dev)
        frozen[:, self.end_token] = 0.0
        step_lp = torch.where(fin[:, None], frozen, step_lp)
        total = log_probs._data.to(dev)[:, None] + step_lp   # [B*W, V]
        flat = total.reshape(b, w * v)
        top_lp, top_idx = torch.topk(flat, w, dim=-1)       # [B, W]
        src_beam = top_idx // v                             # [B, W]
        tok = (top_idx % v).reshape(-1)
        gather = (torch.arange(b, device=dev)[:, None] * w
                  + src_beam).reshape(-1)

        def reorder(s):
            a = s._data if isinstance(s, Tensor) else s
            return Tensor._wrap(a.detach()[gather])

        new_states = [reorder(s) for s in new_states] if isinstance(
            new_states, (list, tuple)) else reorder(new_states)
        new_fin = fin[gather] | (tok == self.end_token)
        return (Tensor._wrap(tok.to(torch.int64)), new_states,
                Tensor._wrap(top_lp.reshape(-1)), Tensor._wrap(new_fin),
                Tensor._wrap(src_beam.reshape(-1)))


def dynamic_decode(decoder, inits=None, max_step_num=None, output_time_major=False,
                   impute_finished=False, is_test=False, return_length=False,
                   **kwargs):
    """Run a decoder until every beam finishes or `max_step_num`
    (the reference's `rnn.py:dynamic_decode`). Returns (ids [B, W, T], final log
    probs [B, W]) after `gather_tree` backtrace."""
    ids, states, log_probs, finished = decoder.initialize(inits)
    max_steps = int(max_step_num or 32)
    step_ids, step_parents = [], []
    w = decoder.beam_size
    for _ in range(max_steps):
        tok, states, log_probs, finished, parents = decoder.step(
            ids, states, log_probs, finished)
        step_ids.append(tok.numpy())
        step_parents.append(parents.numpy())
        ids = tok
        if bool(finished._data.all()):
            break
    t = len(step_ids)
    b = step_ids[0].shape[0] // w
    ids_arr = np.stack(step_ids).reshape(t, b, w)
    par_arr = np.stack(step_parents).reshape(t, b, w)
    traced = F.gather_tree(Tensor(ids_arr), Tensor(par_arr))
    out = Tensor._wrap(torch.movedim(traced._data, 0, -1))
    lp = Tensor._wrap(log_probs._data.reshape(b, w))
    if return_length:
        lengths = Tensor(
            np.full((b, w), t, np.int64), stop_gradient=True)
        return out, lp, lengths
    return out, lp
