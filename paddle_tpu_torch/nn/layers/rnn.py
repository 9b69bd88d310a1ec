"""Recurrent layers (counterpart of paddle_tpu/nn/layers/rnn.py:21-261):
SimpleRNNCell, LSTMCell, GRUCell, RNN, BiRNN, SimpleRNN, LSTM and GRU.

The same parameter names (`weight_ih`, `weight_hh`, `bias_ih`, `bias_hh`;
`cell_<layer>[_reverse]` in the multi-layer layers, `rnn_fw.cell` and
`rnn_bw.cell` in BiRNN) and layouts ([gates * hidden, in], torch's) as the
JAX package; every weight and bias draws U(-1/sqrt(hidden), 1/sqrt(hidden)).
LSTM gates are i, f, g, o and GRU gates r, z, c, as in torch. The time loop
calls the cell once a step, as the JAX package does (a cuDNN LSTM is later
speed work). The JAX package's RNN, BiRNN and multi-layer layers ignore
`sequence_length`; here it raises, rather than give what paddle would not.
"""
from __future__ import annotations

import math

import torch

from ...framework.dtype import convert_dtype
from .. import functional as F
from ..initializer import Uniform
from ..layer import Layer


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None, init_value=0.0,
                           batch_dim_idx=0):
        """[batch, hidden] of `init_value`, f32 unless `dtype` says otherwise."""
        dt = convert_dtype(dtype) if dtype is not None else torch.float32
        return torch.full((batch_ref.shape[batch_dim_idx], self.hidden_size), init_value, dtype=dt,
                          device=batch_ref.device)

    def _params(self, gates, input_size, hidden_size, weight_ih_attr, weight_hh_attr, bias_ih_attr,
                bias_hh_attr):
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        rows = gates * hidden_size
        self.weight_ih = self.create_parameter([rows, input_size], weight_ih_attr,
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([rows, hidden_size], weight_hh_attr,
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([rows], bias_ih_attr, is_bias=True,
                                             default_initializer=init)
        self.bias_hh = self.create_parameter([rows], bias_hh_attr, is_bias=True,
                                             default_initializer=init)

    def _gates(self, x, h):
        """x W_ih^T + h W_hh^T + b_ih + b_hh, summed in the JAX package's order."""
        z = x @ self.weight_ih.t() + h @ self.weight_hh.t()
        for b in (self.bias_ih, self.bias_hh):
            if b is not None:
                z = z + b
        return z


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.activation = activation
        self._params(1, input_size, hidden_size, weight_ih_attr, weight_hh_attr, bias_ih_attr,
                     bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        z = self._gates(inputs, states)
        h = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, proj_size=None, name=None):
        super().__init__()
        self._params(4, input_size, hidden_size, weight_ih_attr, weight_hh_attr, bias_ih_attr,
                     bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self.get_initial_states(inputs)
        else:
            h, c = states
        i, f, g, o = self._gates(inputs, h).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self._params(3, input_size, hidden_size, weight_ih_attr, weight_hh_attr, bias_ih_attr,
                     bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi = inputs @ self.weight_ih.t()
        gh = states @ self.weight_hh.t()
        # as the JAX package: the first bias present goes to gi, a second to gh
        biases = [b for b in (self.bias_ih, self.bias_hh) if b is not None]
        if biases:
            gi = gi + biases[0]
            if len(biases) > 1:
                gh = gh + biases[1]
        ir, iz, ic = gi.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        h = (1 - z) * c + z * states
        return h, h


def _no_sequence_length(sequence_length):
    if sequence_length is not None:
        raise NotImplementedError("sequence_length is not ported: the JAX package ignores it and "
                                  "runs every sequence to the full length")


class RNN(Layer):
    """A cell stepped over time (reversed with is_reverse); [B, T, ...]
    inputs unless time_major. Returns (outputs, final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_sequence_length(sequence_length)
        x = inputs if self.time_major else inputs.transpose(0, 1)
        steps = range(x.shape[0] - 1, -1, -1) if self.is_reverse else range(x.shape[0])
        outs = [None] * x.shape[0]
        states = initial_states
        for t in steps:
            outs[t], states = self.cell(x[t], states)
        y = torch.stack(outs, dim=0)
        return (y if self.time_major else y.transpose(0, 1)), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_sequence_length(sequence_length)
        sf, sb = initial_states if initial_states is not None else (None, None)
        yf, stf = self.rnn_fw(inputs, sf)
        yb, stb = self.rnn_bw(inputs, sb)
        return torch.cat([yf, yb], dim=-1), (stf, stb)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        self._cells = []
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_size = input_size if layer == 0 else hidden_size * self.bidirect
                if mode == "LSTM":
                    cell = LSTMCell(in_size, hidden_size)
                elif mode == "GRU":
                    cell = GRUCell(in_size, hidden_size)
                else:
                    cell = SimpleRNNCell(in_size, hidden_size,
                                         activation="tanh" if mode == "RNN_TANH" else "relu")
                self.add_sublayer(f"cell_{layer}" + ("_reverse" if d == 1 else ""), cell)
                self._cells.append(cell)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """-> (outputs, final states [layers * directions, B, hidden]; for
        LSTM an (h, c) pair of them)."""
        _no_sequence_length(sequence_length)
        x = inputs
        finals = []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.bidirect):
                idx = layer * self.bidirect + d
                init = None
                if initial_states is not None:
                    init = ((initial_states[0][idx], initial_states[1][idx]) if self.mode == "LSTM"
                            else initial_states[idx])
                y, st = RNN(self._cells[idx], d == 1, self.time_major)(x, init)
                outs.append(y)
                finals.append(st)
            x = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
            if self.dropout > 0 and layer < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        if self.mode == "LSTM":
            return x, (torch.stack([s[0] for s in finals]), torch.stack([s[1] for s in finals]))
        return x, torch.stack(finals)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward", time_major=False,
                 dropout=0.0, activation="tanh", **kw):
        super().__init__("RNN_TANH" if activation == "tanh" else "RNN_RELU", input_size,
                         hidden_size, num_layers, direction, time_major, dropout)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward", time_major=False,
                 dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers, direction, time_major, dropout)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward", time_major=False,
                 dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers, direction, time_major, dropout)
