"""The RNN family held against paddle_tpu's on the CPU: the cells, ``RNN``
and ``BiRNN`` with given initial states, and ``SimpleRNN`` / ``LSTM`` /
``GRU`` one- and two-layer, forward and bidirectional, batch- and
time-major, in outputs, final states (paddle's (layers * directions,
batch, hidden) layout) and gradients of the input and every parameter.
The reference's parameters are carried across by name and value (the
names and shapes are the same). The arguments the reference accepts and
ignores (``sequence_length``; ``initial_states`` of the multi-layer
layers) raise in the port, naming the argument.

Tolerance: f32 ``1e-5`` absolute and relative, values and gradients (the
same per-step products and gate math; XLA's scan and PyTorch's loop sum
the products in other orders)."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import place as _place

TOL = dict(rtol=1e-5, atol=1e-5)
I, H, B, T = 6, 8, 3, 5


@pytest.fixture(autouse=True)
def _cpu_place():
    import paddle_tpu_torch as PT

    saved = _place._current
    PT.set_device("cpu")
    yield
    _place._current = saved


def _carry(ref, port):
    sd = ref.state_dict()
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(sd), (names, list(sd))
    with torch.no_grad():
        for n, p in port.named_parameters():
            a = np.array(sd[n].numpy())
            assert tuple(a.shape) == tuple(p.shape), n
            p.copy_(torch.from_numpy(a))


def _flat(x):
    """(tensor, ...) nests flattened in order."""
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _compare(ref, port, inputs, seed, call=lambda layer: layer):
    """Run both (through ``call(layer)``) on the same inputs, backprop
    sum(w * out) over every output and state, and compare the outputs,
    the states and the gradients of the inputs and parameters."""
    rng = np.random.RandomState(seed)
    r_in = [P.to_tensor(a, stop_gradient=False) for a in inputs]
    p_in = [torch.tensor(a, requires_grad=True) for a in inputs]
    r_out = _flat(call(ref)(*r_in))
    p_out = _flat(call(port)(*p_in))
    assert len(r_out) == len(p_out)
    weights = [rng.randn(*t.shape).astype(np.float32) for t in p_out]
    r_loss = sum((t * P.to_tensor(w)).sum() for t, w in zip(r_out, weights))
    p_loss = sum((t * torch.from_numpy(w)).sum()
                 for t, w in zip(p_out, weights))
    r_loss.backward()
    p_loss.backward()
    for i, (r, p) in enumerate(zip(r_out, p_out)):
        assert tuple(r.shape) == tuple(p.shape), (i, r.shape, p.shape)
        np.testing.assert_allclose(p.detach().numpy(), r.numpy(),
                                   err_msg=f"output {i}", **TOL)
    for i, (r, p) in enumerate(zip(r_in, p_in)):
        np.testing.assert_allclose(p.grad.numpy(), r.grad.numpy(),
                                   err_msg=f"input grad {i}", **TOL)
    ref_params = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   ref_params[n].grad.numpy(),
                                   err_msg=f"grad {n}", **TOL)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CELLS = {"SimpleRNNCell": (lambda m: m.SimpleRNNCell(I, H), 1),
         "SimpleRNNCell_relu": (lambda m: m.SimpleRNNCell(
             I, H, activation="relu"), 1),
         "LSTMCell": (lambda m: m.LSTMCell(I, H), 2),
         "GRUCell": (lambda m: m.GRUCell(I, H), 1)}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_matches_reference(name):
    make, n_states = CELLS[name]
    P.seed(1)
    ref = make(P.nn)
    port = make(nn)
    _carry(ref, port)
    x = _x(2, B, I)
    states = [_x(3 + i, B, H) for i in range(n_states)]

    def run(cell):
        def f(xv, *st):
            return cell(xv, tuple(st) if n_states == 2 else st[0])
        return f

    _compare(ref, port, [x, *states], seed=4, call=run)
    # default states: zeros (the reference's single-state cells fail
    # there, so the port is held to itself with explicit zeros)
    zeros = [torch.zeros(B, H) for _ in range(n_states)]
    out, _ = port(torch.from_numpy(x))
    want, _ = port(torch.from_numpy(x),
                   tuple(zeros) if n_states == 2 else zeros[0])
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("cell,reverse,time_major", [
    ("LSTMCell", True, False), ("GRUCell", False, True),
    ("SimpleRNNCell", False, False)])
def test_rnn_over_a_cell_matches_reference(cell, reverse, time_major):
    P.seed(5)
    ref = P.nn.RNN(getattr(P.nn, cell)(I, H), reverse, time_major)
    port = nn.RNN(getattr(nn, cell)(I, H), reverse, time_major)
    _carry(ref, port)
    x = _x(6, *((T, B, I) if time_major else (B, T, I)))
    n_states = 2 if cell == "LSTMCell" else 1
    states = [_x(7 + i, B, H) for i in range(n_states)]

    def run(layer):
        def f(xv, *st):
            return layer(xv, tuple(st) if n_states == 2 else st[0])
        return f

    _compare(ref, port, [x, *states], seed=8, call=run)


def test_birnn_matches_reference():
    P.seed(9)
    ref = P.nn.BiRNN(P.nn.LSTMCell(I, H), P.nn.LSTMCell(I, H))
    port = nn.BiRNN(nn.LSTMCell(I, H), nn.LSTMCell(I, H))
    _carry(ref, port)
    x = _x(10, B, T, I)
    st = [_x(11 + i, B, H) for i in range(4)]

    def run(layer):
        return lambda xv, a, b, c, d: layer(xv, ((a, b), (c, d)))

    _compare(ref, port, [x, *st], seed=12, call=run)


STACKS = [("LSTM", 2, "forward", False), ("LSTM", 2, "bidirect", True),
          ("GRU", 2, "bidirectional", False), ("GRU", 1, "forward", True),
          ("SimpleRNN", 2, "bidirect", False),
          ("SimpleRNN", 1, "forward", False)]


@pytest.mark.parametrize("mode,layers,direction,time_major", STACKS,
                         ids=[f"{m}-{n}-{d}-{int(t)}"
                              for m, n, d, t in STACKS])
def test_stack_matches_reference_in_outputs_states_and_grads(
        mode, layers, direction, time_major):
    P.seed(13)
    ref = getattr(P.nn, mode)(I, H, num_layers=layers, direction=direction,
                              time_major=time_major)
    port = getattr(nn, mode)(I, H, num_layers=layers, direction=direction,
                             time_major=time_major)
    _carry(ref, port)
    x = _x(14, *((T, B, I) if time_major else (B, T, I)))
    out, states = port(torch.from_numpy(x))
    dirs = 2 if direction != "forward" else 1
    for s in _flat(states):
        assert tuple(s.shape) == (layers * dirs, B, H)
    assert out.shape[-1] == dirs * H
    _compare(ref, port, [x], seed=15)


def test_stack_dropout_between_layers_only_in_training():
    torch.manual_seed(0)
    m = nn.LSTM(I, H, num_layers=2, dropout=0.5)
    x = torch.from_numpy(_x(16, B, T, I))
    m.eval()
    a, _ = m(x)
    b, _ = m(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    m.train()
    torch.manual_seed(1)
    c, _ = m(x)
    torch.manual_seed(1)
    d, _ = m(x)
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    assert (c - a).abs().max() > 0


@pytest.mark.parametrize("case", ["rnn_sequence_length",
                                  "birnn_sequence_length",
                                  "stack_sequence_length",
                                  "stack_initial_states"])
def test_ignored_arguments_are_refused(case):
    x = torch.from_numpy(_x(17, B, T, I))
    lens = torch.tensor([5, 3, 2])
    arg = "initial_states" if case == "stack_initial_states" \
        else "sequence_length"
    with pytest.raises(NotImplementedError, match=arg):
        if case == "rnn_sequence_length":
            nn.RNN(nn.GRUCell(I, H))(x, None, lens)
        elif case == "birnn_sequence_length":
            nn.BiRNN(nn.GRUCell(I, H), nn.GRUCell(I, H))(x, None, lens)
        elif case == "stack_sequence_length":
            nn.LSTM(I, H)(x, sequence_length=lens)
        else:
            h0 = torch.zeros(1, B, H)
            nn.LSTM(I, H)(x, initial_states=(h0, h0))
