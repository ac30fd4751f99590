"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``):
the cells ``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, ``RNN`` and
``BiRNN`` that run a cell over a sequence, and the multi-layer
``SimpleRNN``, ``LSTM`` and ``GRU`` with paddle's ``(outputs,
final_states)`` contract.

The recurrence is the reference's, step by step: each step takes both of
the cell's products (``x @ W_ih^T`` and ``h @ W_hh^T``) and adds the
biases in the reference's order; LSTM's gates are split as i, f, g, o,
GRU's as r, z, n with ``n = tanh(i_n + r * h_n)`` and ``h' = (1 - z) * n
+ z * h``. Parameter names and shapes are the reference's, so weights
carry across one to one. No fused RNN of torch or cuDNN is used: their
gate layouts and rounding orders differ.

Where the reference accepts an argument and ignores it, the port raises
instead of computing something else: ``sequence_length`` on ``RNN``,
``BiRNN`` and the multi-layer layers, and ``initial_states`` on the
multi-layer layers.
"""
from __future__ import annotations

import math

import torch

from .. import initializer as I
from ..functional.common import dropout as _dropout
from .common import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU", "BiRNN"]


def _refuse(owner, **ignored):
    for arg, value in ignored.items():
        if value is not None:
            raise NotImplementedError(
                f"{owner}: {arg} is not supported (the reference accepts "
                f"and ignores it; the port refuses it rather than compute "
                f"something else)")


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value``, one (batch, hidden) tensor per state
        (two for an LSTM), in ``dtype`` (float32 by default, as the
        reference's) on ``batch_ref``'s device."""
        from ...core.dtype import to_torch_dtype

        b = batch_ref.shape[batch_dim_idx]
        dt = to_torch_dtype(dtype or "float32")

        def full():
            return torch.full((b, self.hidden_size), init_value, dtype=dt,
                              device=batch_ref.device)

        if isinstance(self.state_shape[0], tuple):
            return tuple(full() for _ in self.state_shape)
        return full()


def _cell_params(layer, input_size, hidden_size, n_gates, weight_ih_attr,
                 weight_hh_attr, bias_ih_attr, bias_hh_attr):
    """weight_ih (G * H, I), weight_hh (G * H, H) and the two (G * H,)
    biases, each uniform in +-1/sqrt(H) (the reference's)."""
    k = 1.0 / math.sqrt(hidden_size)
    layer.weight_ih = layer.create_parameter(
        (n_gates * hidden_size, input_size), attr=weight_ih_attr,
        default_initializer=I.Uniform(-k, k))
    layer.weight_hh = layer.create_parameter(
        (n_gates * hidden_size, hidden_size), attr=weight_hh_attr,
        default_initializer=I.Uniform(-k, k))
    layer.bias_ih = (layer.create_parameter(
        (n_gates * hidden_size,), attr=bias_ih_attr, is_bias=True,
        default_initializer=I.Uniform(-k, k))
        if bias_ih_attr is not False else None)
    layer.bias_hh = (layer.create_parameter(
        (n_gates * hidden_size,), attr=bias_hh_attr, is_bias=True,
        default_initializer=I.Uniform(-k, k))
        if bias_hh_attr is not False else None)


def _biased(z, *biases):
    for b in biases:
        if b is not None:
            z = z + b
    return z


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x @ W_ih^T + h @ W_hh^T + b_ih + b_hh)``, act tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be tanh or relu, got "
                             f"{activation!r}")
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.state_shape = (hidden_size,)
        _cell_params(self, input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = states if states is not None else \
            self.get_initial_states(inputs)
        z = _biased(inputs @ self.weight_ih.t() + h @ self.weight_hh.t(),
                    self.bias_ih, self.bias_hh)
        out = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return out, out


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o (in that order along the rows of the weights):
    ``c' = f * c + i * g``, ``h' = o * tanh(c')``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.state_shape = ((hidden_size,), (hidden_size,))
        _cell_params(self, input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h, c = states if states is not None else \
            self.get_initial_states(inputs)
        z = _biased(inputs @ self.weight_ih.t() + h @ self.weight_hh.t(),
                    self.bias_ih, self.bias_hh)
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    """Gates r, z, n: ``n = tanh(i_n + r * h_n)``, ``h' = (1 - z) * n + z
    * h``, the input and hidden products biased apart."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.state_shape = (hidden_size,)
        _cell_params(self, input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        h = states if states is not None else \
            self.get_initial_states(inputs)
        gi = _biased(inputs @ self.weight_ih.t(), self.bias_ih)
        gh = _biased(h @ self.weight_hh.t(), self.bias_hh)
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        out = (1 - z) * n + z * h
        return out, out


class RNN(Layer):
    """Runs ``cell`` over a (batch, time, ...) sequence ((time, batch,
    ...) when ``time_major``), last step first when ``is_reverse``.
    Returns ``(outputs, final_states)``; the states start at zeros in the
    input's dtype unless ``initial_states`` is given."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        _refuse("RNN.forward", sequence_length=sequence_length, **kwargs)
        states = initial_states
        if states is None:
            states = self.cell.get_initial_states(
                inputs, dtype=inputs.dtype,
                batch_dim_idx=1 if self.time_major else 0)
        seq = inputs if self.time_major else inputs.transpose(0, 1)
        steps = range(seq.shape[0] - 1, -1, -1) if self.is_reverse \
            else range(seq.shape[0])
        outs = [None] * seq.shape[0]
        for t in steps:
            outs[t], states = self.cell(seq[t], states)
        out = torch.stack(outs)
        return (out if self.time_major else out.transpose(0, 1)), states


class BiRNN(Layer):
    """A forward and a reverse :class:`RNN` over the same input, their
    outputs concatenated on the last dim; final states ``(fw, bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse("BiRNN.forward", sequence_length=sequence_length)
        states_fw = states_bw = None
        if initial_states is not None:
            states_fw, states_bw = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    """``num_layers`` stacked :class:`RNN` (or :class:`BiRNN` when
    ``direction`` is ``bidirect`` / ``bidirectional``) layers, dropout
    between them in training. Final states in paddle's (num_layers *
    directions, batch, hidden) layout, forward before backward within a
    layer."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.mode, self.num_layers = mode, num_layers
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        self.hidden_size = hidden_size
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)

        def make_cell(isz):
            if mode == "LSTM":
                return LSTMCell(isz, hidden_size, *attrs)
            if mode == "GRU":
                return GRUCell(isz, hidden_size, *attrs)
            return SimpleRNNCell(isz, hidden_size, activation, *attrs)

        self.rnns = LayerList()
        for i in range(num_layers):
            isz = input_size if i == 0 else hidden_size * self.num_directions
            self.rnns.append(BiRNN(make_cell(isz), make_cell(isz), time_major)
                             if bidirect
                             else RNN(make_cell(isz), False, time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _refuse(f"{type(self).__name__}.forward",
                initial_states=initial_states,
                sequence_length=sequence_length)
        out = inputs
        finals = []
        for i, rnn in enumerate(self.rnns):
            out, st = rnn(out)
            finals.append(st)
            if self.dropout > 0 and i < self.num_layers - 1:
                out = _dropout(out, self.dropout, training=self.training)
        if self.num_directions == 2:
            finals = [s for pair in finals for s in pair]
        if self.mode == "LSTM":
            return out, (torch.stack([s[0] for s in finals]),
                         torch.stack([s[1] for s in finals]))
        return out, torch.stack(finals)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)
