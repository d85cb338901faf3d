"""Recurrent layers: the port of `paddle_tpu/nn/layer/rnn.py`.

The JAX package runs each recurrence as a `lax.scan` (no Pallas kernel);
the port runs the same step (`_cell_step`, `rnn.py:22-57`) in a Python
loop over time, one registered op for a whole multi-layer RNN, with
torch autograd for BPTT:
- LSTM gates split `i, f, g, o`; `c = f * c + i * g`, `h = o * tanh(c)`;
- GRU biases are added before the split, `n = tanh(i_n + r * h_n)` and
  `h = (1 - z) * n + z * h`;
- SimpleRNN is `tanh` or `relu` of `x W_ih^T + h W_hh^T + b_ih + b_hh`.
Parameters keep the JAX package's names and layouts
(`weight_ih_l{k}[_reverse]` `[gates * hidden, in]`, `weight_hh_...`,
`bias_ih_...`, `bias_hh_...`), drawn from `Uniform(+-1 / sqrt(hidden))`.
The inter-layer dropout (training, more than one layer) keeps each
element of layer k's input with the bits of
`bernoulli(fold_in(key, k), 1 - p)` on one key of the shared generator
(`rnn.py:71-76`); the per-layer keys are folded on the host and enter the
op as a tensor.

`sequence_length` is not supported: the JAX package accepts and ignores
it, which runs padded steps as real ones; the port raises
`NotImplementedError` for a non-None value instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...framework import random as random_mod
from ...ops._helpers import as_tensor
from ..initializer import Uniform
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


def _no_sequence_length(sequence_length):
    if sequence_length is not None:
        raise NotImplementedError(
            "sequence_length is not supported: pass full-length sequences "
            "(the JAX package ignores it and runs the padded steps)")


def _cell_step(mode, x, state, w_ih, w_hh, b_ih, b_hh, activation="tanh"):
    if mode == "LSTM":
        h, c = state
        gates = x @ w_ih.T + h @ w_hh.T
        if b_ih is not None:
            gates = gates + b_ih + b_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return h, (h, c)
    if mode == "GRU":
        h = state
        gi = x @ w_ih.T
        gh = h @ w_hh.T
        if b_ih is not None:
            gi = gi + b_ih
            gh = gh + b_hh
        i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
        h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * h
        return h, h
    h = state
    out = x @ w_ih.T + h @ w_hh.T
    if b_ih is not None:
        out = out + b_ih + b_hh
    h = torch.tanh(out) if activation == "tanh" else torch.relu(out)
    return h, h


def _rnn_fn(mode, num_layers, bidirectional, has_bias, time_major,
            activation, x, init_states, weights, dropout=0.0, keys=None):
    """x `[B, T, I]` (`[T, B, I]` if time_major) -> (out, h_n[, c_n])."""
    if not time_major:
        x = x.transpose(0, 1)                        # -> [T, B, I]
    num_dir = 2 if bidirectional else 1
    stride = 4 if has_bias else 2
    layer_in = x
    final_h, final_c = [], []
    for layer in range(num_layers):
        if layer > 0 and keys is not None:
            u = random_mod._unit_floats(keys[layer - 1],
                                        tuple(layer_in.shape),
                                        torch.float64, layer_in.device)
            layer_in = torch.where(u < 1.0 - dropout,
                                   layer_in / (1.0 - dropout),
                                   torch.zeros((), dtype=layer_in.dtype,
                                               device=layer_in.device))
        dir_outs = []
        for d in range(num_dir):
            wi = (layer * num_dir + d) * stride
            w_ih, w_hh = weights[wi], weights[wi + 1]
            b_ih = weights[wi + 2] if has_bias else None
            b_hh = weights[wi + 3] if has_bias else None
            idx = layer * num_dir + d
            st = (init_states[0][idx], init_states[1][idx]) \
                if mode == "LSTM" else init_states[0][idx]
            steps = range(layer_in.shape[0])
            outs = [None] * layer_in.shape[0]
            for t in (reversed(steps) if d == 1 else steps):
                outs[t], st = _cell_step(mode, layer_in[t], st, w_ih, w_hh,
                                         b_ih, b_hh, activation)
            dir_outs.append(torch.stack(outs))
            if mode == "LSTM":
                final_h.append(st[0])
                final_c.append(st[1])
            else:
                final_h.append(st)
        layer_in = torch.cat(dir_outs, dim=-1) if num_dir == 2 \
            else dir_outs[0]
    out = layer_in if time_major else layer_in.transpose(0, 1)
    if mode == "LSTM":
        return out, torch.stack(final_h), torch.stack(final_c)
    return out, torch.stack(final_h)


def _register_rnn_ops():
    for mode in ("LSTM", "GRU", "RNN_TANH", "RNN_RELU"):
        base = mode if mode in ("LSTM", "GRU") else "RNN"
        act = "relu" if mode == "RNN_RELU" else "tanh"

        def fn(*arrays, mode=base, act=act, num_layers=1,
               bidirectional=False, has_bias=True, time_major=False,
               n_states=1, dropout=0.0, has_key=False):
            x = arrays[0]
            states = arrays[1:1 + n_states]
            rest = arrays[1 + n_states:]
            keys = rest[-1] if has_key else None
            weights = rest[:-1] if has_key else rest
            return _rnn_fn(mode, num_layers, bidirectional, has_bias,
                           time_major, act, x, states, weights, dropout,
                           keys)

        dispatch.register_op(f"rnn_{mode.lower()}", fn, multi_out=True)


_register_rnn_ops()


def _simple_cell_fn(x, h, w_ih, w_hh, b_ih=None, b_hh=None, *,
                    activation="tanh"):
    return _cell_step("RNN", x, h, w_ih, w_hh, b_ih, b_hh, activation)[0]


def _lstm_cell_fn(x, h, c, w_ih, w_hh, b_ih=None, b_hh=None):
    return _cell_step("LSTM", x, (h, c), w_ih, w_hh, b_ih, b_hh)[1]


def _gru_cell_fn(x, h, w_ih, w_hh, b_ih=None, b_hh=None):
    return _cell_step("GRU", x, h, w_ih, w_hh, b_ih, b_hh)[0]


dispatch.register_op("simple_rnn_cell", _simple_cell_fn)
dispatch.register_op("lstm_cell", _lstm_cell_fn, multi_out=True)
dispatch.register_op("gru_cell", _gru_cell_fn)


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        d = batch_ref._data

        def full(s):
            return Tensor._wrap(torch.full((batch,) + tuple(s), init_value,
                                           dtype=d.dtype, device=d.device))

        if isinstance(self.state_shape[0], (list, tuple)):
            return tuple(full(s) for s in self.state_shape)
        return full(self.state_shape)


def _cell_params(layer, input_size, hidden_size, gates, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
    std = 1.0 / np.sqrt(hidden_size)
    init = Uniform(-std, std)
    layer.weight_ih = layer.create_parameter(
        [gates * hidden_size, input_size], attr=weight_ih_attr,
        default_initializer=init)
    layer.weight_hh = layer.create_parameter(
        [gates * hidden_size, hidden_size], attr=weight_hh_attr,
        default_initializer=init)
    layer.bias_ih = None if bias_ih_attr is False else \
        layer.create_parameter([gates * hidden_size], attr=bias_ih_attr,
                               is_bias=True, default_initializer=init)
    layer.bias_hh = None if bias_hh_attr is False else \
        layer.create_parameter([gates * hidden_size], attr=bias_hh_attr,
                               is_bias=True, default_initializer=init)


def _cell_args(cell, head):
    args = head + [cell.weight_ih, cell.weight_hh]
    if cell.bias_ih is not None:
        args += [cell.bias_ih, cell.bias_hh]
    return args


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = dispatch.apply("simple_rnn_cell",
                             _cell_args(self, [inputs, states]),
                             {"activation": self.activation})
        return out, out


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        nh, nc = dispatch.apply("lstm_cell", _cell_args(self,
                                                         [inputs, h, c]))
        return nh, (nh, nc)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        _cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = dispatch.apply("gru_cell", _cell_args(self, [inputs, states]))
        return out, out


class RNN(Layer):
    """A cell stepped over time (paddle.nn.RNN)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops import manipulation

        _no_sequence_length(sequence_length)
        t_axis = 0 if self.time_major else 1
        xs = manipulation.unbind(inputs, axis=t_axis)
        if self.is_reverse:
            xs = xs[::-1]
        state = initial_states
        outs = []
        for xt in xs:
            out, state = self.cell(xt, state)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return manipulation.stack(outs, axis=t_axis), state


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops import manipulation

        _no_sequence_length(sequence_length)
        st_fw, st_bw = initial_states if initial_states is not None \
            else (None, None)
        out_fw, s_fw = self.rnn_fw(inputs, st_fw)
        out_bw, s_bw = self.rnn_bw(inputs, st_bw)
        return manipulation.concat([out_fw, out_bw], axis=-1), (s_fw, s_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.has_bias = bias_ih_attr is not False
        num_dir = 2 if self.bidirectional else 1
        gates = {"LSTM": 4, "GRU": 3}.get(mode, 1)
        std = 1.0 / np.sqrt(hidden_size)
        init = Uniform(-std, std)
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(num_dir):
                in_size = input_size if layer == 0 else hidden_size * num_dir
                sfx = f"l{layer}" + ("_reverse" if d else "")
                shapes = [("weight_ih", [gates * hidden_size, in_size],
                           weight_ih_attr, False),
                          ("weight_hh", [gates * hidden_size, hidden_size],
                           weight_hh_attr, False)]
                if self.has_bias:
                    shapes += [("bias_ih", [gates * hidden_size],
                                bias_ih_attr, True),
                               ("bias_hh", [gates * hidden_size],
                                bias_hh_attr, True)]
                for base, shape, attr, is_bias in shapes:
                    self.add_parameter(f"{base}_{sfx}", self.create_parameter(
                        shape, attr=attr, is_bias=is_bias,
                        default_initializer=init))
                    self._weight_names.append(f"{base}_{sfx}")

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_sequence_length(sequence_length)
        inputs = as_tensor(inputs)
        num_dir = 2 if self.bidirectional else 1
        if initial_states is None:
            d = inputs._data
            batch = inputs.shape[1 if self.time_major else 0]
            zeros = torch.zeros((self.num_layers * num_dir, batch,
                                 self.hidden_size), dtype=d.dtype,
                                device=d.device)
            initial_states = (Tensor._wrap(zeros), Tensor._wrap(zeros)) \
                if self.mode == "LSTM" else Tensor._wrap(zeros)
        states = list(initial_states) \
            if isinstance(initial_states, (tuple, list)) \
            else [initial_states]
        weights = [getattr(self, n) for n in self._weight_names]
        op = {"LSTM": "rnn_lstm", "GRU": "rnn_gru"}.get(
            self.mode, "rnn_rnn_relu" if self.activation == "relu"
            else "rnn_rnn_tanh")
        use_dropout = self.dropout > 0.0 and self.training \
            and self.num_layers > 1
        extra = []
        if use_dropout:
            key = random_mod.next_key()
            extra = [Tensor._wrap(torch.tensor(
                [random_mod.fold_in(key, k)
                 for k in range(1, self.num_layers)], dtype=torch.int64,
                device=inputs._data.device))]
        outs = dispatch.apply(op, [inputs] + states + weights + extra,
                              {"num_layers": self.num_layers,
                               "bidirectional": self.bidirectional,
                               "has_bias": self.has_bias,
                               "time_major": self.time_major,
                               "n_states": len(states),
                               "dropout": float(self.dropout)
                               if use_dropout else 0.0,
                               "has_key": use_dropout})
        if self.mode == "LSTM":
            out, h, c = outs
            return out, (h, c)
        out, h = outs
        return out, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
