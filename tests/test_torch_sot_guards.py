"""Value guards in ``to_static`` held against the reference on the CPU:
a branch on a tensor's value is never baked at trace time. The
reference's SOT-lite guards (graph break, eager record, one
specialization per observed outcome, checked on later calls) are
TorchDynamo's graph breaks and guards in the port: the code before the
branch is one graph, the branch is evaluated in Python, the continuation
another graph, and a closed-over tensor is a graph input, so a changed
value takes the other branch. Each case runs the same function through
``paddle_tpu.jit.to_static`` and ``paddle_tpu_torch.jit.to_static`` on the
same inputs; results equal to 1e-6 relative."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch import jit
from paddle_tpu_torch.core import place as _place


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = _place._current
    T.set_device("cpu")
    yield
    _place._current = saved


def _both(body):
    """The same body through both packages' to_static."""
    return P.jit.to_static(body), jit.to_static(body)


def _agree(rf, f, x, want=None):
    rout = np.asarray(rf(P.to_tensor(x))._value)
    out = f(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), rout, rtol=1e-6)
    if want is not None:
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)
    return out


def test_value_branch_changes_across_calls():
    def body(x):
        if x.mean() > 0:
            return x * 2.0
        return x - 10.0

    rf, f = _both(body)
    pos, neg = np.full(4, 3.0, "f4"), np.full(4, -3.0, "f4")
    for x, want in [(pos, 6.0), (neg, -13.0)] * 2:
        _agree(rf, f, x, np.full(4, want))
    assert f.graph_breaks  # the value branch broke full_graph


def test_guard_cache_entries_stay_bounded():
    def body(x):
        if x.sum() > 0:
            return x + 1.0
        return x - 1.0

    rf, f = _both(body)
    a, b = np.ones(3, "f4"), -np.ones(3, "f4")
    _agree(rf, f, a)
    _agree(rf, f, b)
    n = len(f.graphs)
    for x in (a, b, a):
        _agree(rf, f, x)
    assert len(f.graphs) == n  # repeats compile nothing new
    entry = next(iter(rf._jit_cache.values()))
    assert set(entry["specs"]) >= {(True,), (False,)}


def test_specialization_verified_not_trusted():
    def body(x):
        if x.mean() > 0:
            return x * 0.0 + 111.0
        return x * 0.0 + 222.0

    rf, f = _both(body)
    for val, expect in [(5.0, 111.0), (-5.0, 222.0)] * 3:
        _agree(rf, f, np.full(2, val, "f4"), np.full(2, expect))


def test_nested_guards_respecialize():
    def body(x):
        if x.mean() > 0:
            if x.max() > 10.0:
                return x * 100.0
            return x * 2.0
        return -x

    rf, f = _both(body)
    small, big, neg = (np.full(3, v, "f4") for v in (1.0, 20.0, -1.0))
    for x, want in [(small, 2.0), (big, 2000.0), (neg, 1.0), (big, 2000.0),
                    (small, 2.0)]:
        _agree(rf, f, x, np.full(3, want))


def test_guarded_layer_trains_with_grads():
    def gated(mod):
        class Gated(mod.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = mod.nn.Linear(4, 4)

            def forward(self, x):
                h = self.lin(x)
                if h.mean() > 0:
                    return h * 2.0
                return h * 0.5

        return Gated()

    P.seed(0)
    rm = gated(P)
    m = gated(T)
    with torch.no_grad():
        m.lin.weight.copy_(torch.from_numpy(
            np.array(rm.lin.weight._value).T.copy()))
        m.lin.bias.copy_(torch.from_numpy(np.array(rm.lin.bias._value)))
    rm.forward = P.jit.to_static(rm.forward)
    m.forward = jit.to_static(m.forward)
    x = np.ones((2, 4), "f4")
    rm(P.to_tensor(x)).mean().backward()
    m(torch.from_numpy(x)).mean().backward()
    g = m.lin.weight.grad
    assert g is not None and float(g.abs().sum()) > 0
    np.testing.assert_allclose(g.numpy().T, rm.lin.weight.grad.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_one_graph_refused_on_a_traced_bool():
    """Outside to_static's handling the loud error stays: one graph
    (Dynamo's fullgraph) cannot hold a branch on a tensor's value, as a
    plain jax.jit cannot in the reference."""
    def f(t):
        if t.mean() > 0:
            return t
        return -t

    with pytest.raises(torch._dynamo.exc.Unsupported,
                       match="[Dd]ata-dependent"):
        torch.compile(f, backend="aot_eager", fullgraph=True)(torch.ones(3))


def test_ndarray_args_become_tensors():
    def body(x):
        if x.mean() > 0:
            return x * 2.0
        return x - 1.0

    rf, f = _both(body)
    for v, want in ((3.0, 6.0), (-3.0, -4.0)):
        x = np.full(4, v, "f4")
        out = f(x)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_allclose(out.numpy(), np.full(4, want))
        np.testing.assert_allclose(np.asarray(rf(x)._value), out.numpy())


def test_concrete_tensor_bool_stays_aligned():
    rflag = P.to_tensor(np.asarray(1.0, "f4"))
    flag = torch.tensor(1.0)

    def make(fl):
        def body(x):
            if fl:
                x = x + 10.0
            if x.mean() > 0:
                return x * 2.0
            return -x

        return body

    rf, f = P.jit.to_static(make(rflag)), jit.to_static(make(flag))
    for v, want in ((1.0, 22.0), (-100.0, 90.0), (1.0, 22.0)):
        _agree(rf, f, np.full(2, v, "f4"), np.full(2, want))


def test_nested_to_static_inlines_into_outer():
    def inner_body(x):
        if x.mean() > 0:
            return x * 3.0
        return x / 3.0

    rinner, inner = _both(inner_body)
    rf = P.jit.to_static(lambda x: rinner(x) + 1.0)
    f = jit.to_static(lambda x: inner(x) + 1.0)
    for v, want in ((3.0, 10.0), (-3.0, 0.0)):
        _agree(rf, f, np.full(2, v, "f4"), np.full(2, want))


def test_guard_cache_bounded_then_correct():
    """Four value branches give up to 16 paths: the reference stops at
    ``_MAX_GUARD_SPECS`` specializations and runs eagerly; Dynamo's
    continuations are compiled once per resume point and its recompile
    limit is the same 8, so the port compiles a bounded number of graphs
    and every call is right."""
    from paddle_tpu.jit import _MAX_GUARD_SPECS as REF_MAX

    assert jit._MAX_GUARD_SPECS == REF_MAX
    assert torch._dynamo.config.recompile_limit == REF_MAX

    def body(x):
        y = x
        for thresh in (0.0, 1.0, 2.0, 3.0):
            if y.mean() > thresh:
                y = y + 1.0
        return y

    rf, f = _both(body)
    rng = np.random.RandomState(0)
    for _ in range(40):
        x = rng.uniform(-4, 4, 3).astype("f4")
        want = x.copy()
        for thresh in (0.0, 1.0, 2.0, 3.0):
            if want.mean() > thresh:
                want = want + 1.0
        _agree(rf, f, x, want)
    assert len(f.graphs) <= 2 * (4 + 1) * REF_MAX


def test_stale_concrete_guard_recheck():
    """A closed-over tensor the function branches on: after it changes,
    the next call takes the other branch (the reference re-checks its
    host guard; Dynamo reads the tensor as a graph input)."""
    rflag = P.to_tensor(np.asarray(1.0, "f4"))
    flag = torch.tensor(1.0)

    def make(fl):
        def body(x):
            if fl:
                return x + 100.0
            return x - 100.0

        return body

    rf, f = P.jit.to_static(make(rflag)), jit.to_static(make(flag))
    x = np.zeros(2, "f4")
    for set_to, want in ((None, 100.0), (None, 100.0), (0.0, -100.0),
                         (1.0, 100.0)):
        if set_to is not None:
            rflag._value = rflag._value * 0.0 + set_to
            flag.fill_(set_to)
        _agree(rf, f, x, np.full(2, want))
