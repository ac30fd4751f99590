"""The port's serial MoE layer and gates held against paddle_tpu's on the
CPU. Weights are drawn by the reference from its seed and carried with
``nlp.convert`` (the expert stacks and the gate copy as they are); inputs
come from ``np.random.RandomState``. The gates' top-k picks are only
compared where no two of a token's probabilities tie: ``torch.topk``'s
order at an exact tie is not ``lax.top_k``'s (ROADMAP queue C), and f32
softmax probabilities of normal draws do not tie.

Tolerances: outputs, ``l_aux`` and gradients in f32 ``1e-5`` absolute and
relative (the same f32 products summed in other orders); the two
dispatch modes of the port against each other ``2e-4`` relative and
``1e-5`` absolute (the reference's own test's bounds); dispatch masks,
capacities and dropped tokens equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import MoELayer as RefMoE
from paddle_tpu.incubate.distributed.models.moe import gate as ref_gate
from paddle_tpu.parallel import mesh as mesh_state
from paddle_tpu_torch.incubate.distributed.models.moe import (GShardGate,
                                                              MoELayer,
                                                              SwitchGate,
                                                              TopKGate)
from paddle_tpu_torch.nlp import load_paddle_tpu_arrays

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(seed=7, shape=(6, 8, 16)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _loss_and_grads(moe, x, torch_side):
    if torch_side:
        xt = torch.from_numpy(x).requires_grad_()
        y = moe(xt)
        loss = (y * y).mean() + 0.01 * moe.l_aux
        loss.backward()
        return (y.detach().numpy(), float(moe.l_aux.detach()),
                {n: p.grad.numpy() for n, p in moe.named_parameters()},
                xt.grad.numpy())
    mesh_state.set_mesh(None)
    xr = paddle.to_tensor(x)
    xr.stop_gradient = False
    y = moe(xr)
    loss = (y * y).mean() + 0.01 * moe.l_aux
    loss.backward()
    return (y.numpy(), float(moe.l_aux),
            {n: p.grad.numpy() for n, p in moe.named_parameters()},
            xr.grad.numpy())


def _pair(mode, gate="gshard", act="swiglu", cf=2.0, seed=5, e=4):
    paddle.seed(seed)
    mesh_state.set_mesh(None)
    ref = RefMoE(16, 32, num_experts=e, gate=gate, capacity_factor=cf,
                 activation=act, dispatch_mode=mode)
    port = MoELayer(16, 32, num_experts=e, gate=gate, capacity_factor=cf,
                    activation=act, dispatch_mode=mode, device="cpu")
    load_paddle_tpu_arrays(port, {k: np.asarray(v._value)
                                  for k, v in ref.state_dict().items()})
    return ref, port


@pytest.mark.parametrize("mode", ["einsum", "grouped"])
@pytest.mark.parametrize("gate", ["gshard", "switch"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_layer_matches_reference_f32(mode, gate, act):
    ref, port = _pair(mode, gate, act)
    assert port.dispatch_mode == ref.dispatch_mode == mode
    x = _x()
    y_r, aux_r, g_r, dx_r = _loss_and_grads(ref, x, False)
    y_p, aux_p, g_p, dx_p = _loss_and_grads(port, x, True)
    assert y_p.shape == (6, 8, 16)
    np.testing.assert_allclose(y_p, y_r, **TOL)
    np.testing.assert_allclose(aux_p, aux_r, **TOL)
    np.testing.assert_allclose(dx_p, dx_r, **TOL)
    assert sorted(g_p) == sorted(g_r)
    for n in g_r:
        np.testing.assert_allclose(g_p[n], g_r[n], err_msg=n, **TOL)


@pytest.mark.parametrize("mode", ["einsum", "grouped"])
def test_same_dropped_tokens_under_capacity(mode):
    """Capacity factor 0.5 drops tokens; the port drops the same ones as
    the reference (round-major, token-order queues), in both modes."""
    ref, port = _pair(mode, cf=0.5)
    x = _x()
    y_r, aux_r, _, _ = _loss_and_grads(ref, x, False)
    y_p, aux_p, _, _ = _loss_and_grads(port, x, True)
    np.testing.assert_allclose(y_p, y_r, **TOL)
    np.testing.assert_allclose(aux_p, aux_r, **TOL)
    logits = _x(8, (48, 4)) * 2
    t_gate, r_gate = GShardGate(0.5), ref_gate.GShardGate(0.5)
    d_p, c_p, cap_p = t_gate(torch.from_numpy(logits))
    d_r, c_r, cap_r = r_gate(paddle.to_tensor(logits)._value)
    assert cap_p == cap_r == 12
    np.testing.assert_array_equal(d_p.numpy(), np.asarray(d_r))
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_r), **TOL)
    i_p, v_p, _ = t_gate.topk_assignments(torch.from_numpy(logits))
    i_r, v_r, _ = r_gate.topk_assignments(paddle.to_tensor(logits)._value)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_r))
    dropped = v_p.numpy() == 0
    np.testing.assert_array_equal(dropped, np.asarray(v_r) == 0)
    assert 0 < dropped.sum() < dropped.size
    # each dispatch slot holds at most one token, every expert at most cap
    assert d_p.sum(0).max() <= 1 and d_p.sum((0, 2)).max() <= cap_p
    assert int(d_p.sum()) == int((~dropped).sum())


def test_forward_backward():
    """tests/test_incubate_inference.py's MoE test on the port."""
    moe = MoELayer(16, 32, num_experts=4, gate="gshard", device="cpu",
                   generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_x(1, (4, 8, 16))).requires_grad_()
    y = moe(x)
    assert y.shape == (4, 8, 16)
    ((y * y).mean() + 0.01 * moe.l_aux).backward()
    assert float(moe.gate_weight.grad.abs().sum()) > 0
    assert float(moe.w1.grad.abs().sum()) > 0


def test_capacity_drops_overflow():
    moe = MoELayer(8, 16, num_experts=2, gate=SwitchGate(capacity_factor=0.5),
                   device="cpu", generator=torch.Generator().manual_seed(2))
    assert moe(torch.from_numpy(_x(2, (16, 8)))).shape == (16, 8)


def _port_run(mode, cf=2.0):
    _, port = _pair(mode, cf=cf)
    return _loss_and_grads(port, _x(), True)


def test_grouped_matches_einsum():
    """The reference's grouped-against-einsum tests on the port, with and
    without capacity pressure."""
    for cf in (2.0, 0.5):
        yg, auxg, gg, _ = _port_run("grouped", cf)
        ye, auxe, ge, _ = _port_run("einsum", cf)
        np.testing.assert_allclose(yg, ye, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(auxg, auxe, rtol=1e-5)
        for n in ge:
            np.testing.assert_allclose(gg[n], ge[n], rtol=2e-4, atol=1e-5,
                                       err_msg=f"cf={cf} {n}")
    roomy = _port_run("grouped", 2.0)[0]
    assert np.abs(yg - roomy).max() > 1e-6, "capacity 0.5 dropped nothing"


def test_custom_gate_takes_einsum_and_expert_parallel_refuses():
    class Plain:
        def __init__(self):
            self.inner = TopKGate(2, 2.0)
            self.l_aux = None

        def __call__(self, logits):
            out = self.inner(logits)
            self.l_aux = self.inner.l_aux
            return out

    moe = MoELayer(16, 32, 4, gate=Plain(), device="cpu")
    assert moe.dispatch_mode == "einsum"
    assert moe(torch.from_numpy(_x())).shape == (6, 8, 16)
    with pytest.raises(NotImplementedError, match="A7"):
        MoELayer(16, 32, 4, expert_axis="dp", device="cpu")
    with pytest.raises(ValueError, match="dispatch_mode"):
        MoELayer(16, 32, 4, dispatch_mode="ragged", device="cpu")
