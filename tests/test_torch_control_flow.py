"""``paddle_tpu_torch.static.nn`` control flow held against
``paddle_tpu.static.nn`` on the CPU: eagerly each op runs as Python (one
branch, an unrolled loop, gradients through both); under
``jit.to_static`` a tensor predicate becomes ``torch.cond`` and a loop
``while_loop`` inside one graph (no graph break), as the reference's
lower to ``lax.cond`` / ``lax.while_loop`` under ``jax.jit``. Same inputs
in both packages; results equal to 1e-6 relative."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.static import nn as rnn
from paddle_tpu_torch import jit
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.static.nn import case, cond, switch_case, while_loop


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = _place._current
    T.set_device("cpu")
    yield
    _place._current = saved


def _ref_jit(fn):
    """``fn`` on reference Tensors under ``jax.jit`` (traced
    predicates)."""
    from paddle_tpu.core import autograd
    from paddle_tpu.core.tensor import Tensor

    @jax.jit
    def run(v):
        with autograd.no_grad():
            return fn(Tensor(v, stop_gradient=True))._value

    return lambda x: np.asarray(run(x))


def test_cond_eager_both_branches():
    x = T.to_tensor(np.array(3.0, "f4"))
    rx = P.to_tensor(np.array(3.0, "f4"))
    for pred, rpred in ((x > 0, rx > 0), (x < 0, rx < 0)):
        out = cond(pred, lambda: x * 2, lambda: x - 1)
        rout = rnn.cond(rpred, lambda: rx * 2, lambda: rx - 1)
        assert float(out) == float(rout)
    assert float(cond(True, lambda: x * 2, lambda: x - 1)) == 6.0


def test_cond_inside_to_static_is_one_graph():
    def body(mod, nn_):
        return lambda t: nn_.cond(t.sum() > 0, lambda: t * 10,
                                  lambda: t * -1)

    f = jit.to_static(body(T, T.static.nn))
    rf = _ref_jit(body(P, rnn))
    for x in (np.ones(3, "f4"), -np.ones(3, "f4")):
        np.testing.assert_allclose(f(torch.from_numpy(x)).numpy(), rf(x))
    assert f.graph_breaks == [] and len(f.graphs) == 1
    assert any("cond" in str(n.target) for n in f.graphs[0].graph.nodes)


def test_cond_gradients_flow_eager_and_traced():
    x = torch.tensor([2.0], requires_grad=True)
    out = cond(x.sum() > 0, lambda: (x ** 2).sum(), lambda: x.sum())
    (g,) = T.grad(out, [x])
    rx = P.to_tensor(np.array([2.0], "f4"))
    rx.stop_gradient = False
    rout = rnn.cond(rx.sum() > 0, lambda: (rx ** 2).sum(), lambda: rx.sum())
    (rg,) = P.grad(rout, [rx])
    np.testing.assert_allclose(g.numpy(), np.asarray(rg._value), rtol=1e-6)

    f = jit.to_static(lambda t: cond(t.sum() > 0, lambda: (t ** 2).sum(),
                                     lambda: t.sum()))
    y = torch.tensor([2.0], requires_grad=True)
    (g2,) = torch.autograd.grad(f(y), [y])
    np.testing.assert_allclose(g2.numpy(), [4.0], rtol=1e-6)
    assert f.graph_breaks == []


def test_while_loop_counts_eager_and_traced():
    i, s = T.to_tensor(np.array(0, "i4")), T.to_tensor(np.array(0.0, "f4"))
    i2, s2 = while_loop(lambda i, s: i < 5, lambda i, s: [i + 1, s + 2.0],
                        [i, s])
    ri2, rs2 = rnn.while_loop(
        lambda i, s: i < 5, lambda i, s: [i + 1, s + 2.0],
        [P.to_tensor(np.array(0, "i4")), P.to_tensor(np.array(0.0, "f4"))])
    assert (int(i2), float(s2)) == (int(ri2), float(rs2)) == (5, 10.0)

    @jit.to_static
    def f(n):
        out = while_loop(lambda i, s: i < n, lambda i, s: [i + 1, s + 2.0],
                         [torch.zeros((), dtype=torch.int32),
                          torch.zeros(())])
        return out[1]

    assert float(f(torch.tensor(5, dtype=torch.int32))) == 10.0
    assert float(f(torch.tensor(7, dtype=torch.int32))) == 14.0
    assert f.graph_breaks == []


def test_case_and_switch_eager_and_traced():
    x, rx = T.to_tensor(np.array(1.0, "f4")), P.to_tensor(
        np.array(1.0, "f4"))
    out = case([(x > 2, lambda: x * 100), (x > 0, lambda: x * 10)],
               default=lambda: x)
    rout = rnn.case([(rx > 2, lambda: rx * 100), (rx > 0, lambda: rx * 10)],
                    default=lambda: rx)
    assert float(out) == float(rout) == 10.0
    branches = lambda v: {0: lambda: v + 1, 2: lambda: v + 2,  # noqa: E731
                          5: lambda: v + 5}
    for idx, want in ((2, 3.0), (7, 6.0)):  # 7: unknown -> the last branch
        out = switch_case(T.to_tensor(np.array(idx, "i4")), branches(x))
        rout = rnn.switch_case(P.to_tensor(np.array(idx, "i4")),
                               branches(rx))
        assert float(out) == float(rout) == want

    @jit.to_static
    def g(v, idx):
        a = case([(v > 2, lambda: v * 100), (v > 0, lambda: v * 10)],
                 default=lambda: v)
        return a + switch_case(idx, branches(v), default=lambda: v * 0)

    for v, idx, want in ((1.0, 2, 13.0), (3.0, 5, 308.0), (-1.0, 7, -1.0)):
        got = g(torch.tensor(v), torch.tensor(idx, dtype=torch.int32))
        assert float(got) == want
    assert g.graph_breaks == []


def test_while_loop_eager_grads_unroll():
    x = torch.tensor(2.0, requires_grad=True)
    _, y = while_loop(lambda i, y: i < 3, lambda i, y: [i + 1, y * 2.0],
                      [torch.tensor(0, dtype=torch.int32), x])
    (g,) = T.grad(y, [x])
    rx = P.to_tensor(np.array(2.0, "f4"))
    rx.stop_gradient = False
    _, ry = rnn.while_loop(lambda i, y: i < 3, lambda i, y: [i + 1, y * 2.0],
                           [P.to_tensor(np.array(0, "i4")), rx])
    (rg,) = P.grad(ry, [rx])
    assert float(y) == float(ry) == 16.0 and float(g) == float(rg) == 8.0


def test_cond_single_branch_returns_none():
    x = T.to_tensor(np.array(-1.0, "f4"))
    assert cond(x > 0, lambda: x * 2) is None
    assert rnn.cond(P.to_tensor(np.array(-1.0, "f4")) > 0, lambda: 1) is None


def test_while_loop_unstable_carry_raises():
    """A body that changes a carry's dtype raises, traced (as the
    reference's under jax.jit) and, in the port, eagerly too."""
    body = lambda i: [i + 0.5]  # noqa: E731  (float out of an int carry)
    with pytest.raises(TypeError, match="shape/dtype-stable"):
        _ref_jit(lambda t: rnn.while_loop(lambda i: i < 3, body, [t])[0])(
            np.array(0, "i4"))
    with pytest.raises(TypeError, match="shape/dtype-stable"):
        while_loop(lambda i: i < 3, body,
                   [torch.tensor(0, dtype=torch.int32)])
    f = jit.to_static(lambda t: while_loop(lambda i: i < 3, body, [t])[0])
    with pytest.raises(TypeError, match="shape/dtype-stable"):
        f(torch.tensor(0, dtype=torch.int32))
