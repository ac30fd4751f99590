"""The port's vision models held against paddle_tpu's on the CPU:
``resnet18`` and ``resnet50`` (BASELINE config #1) forward and one
``Momentum`` train step, and the ``LeNet``, ``vgg11`` and
``mobilenet_v2`` forwards. The reference builds each model from its seed;
its ``state_dict()`` (parameters and BatchNorm's ``_mean`` /
``_variance``, set away from 0 / 1 first so that the carry of the buffers
shows) is carried with ``vision.load_paddle_tpu_arrays``. Inputs come
from ``np.random.RandomState``.

Tolerances, each with its reason:
- f32 logits: ``1e-4`` of the largest |logit| plus ``1e-4`` relative (the
  same convolutions, BatchNorms and products summed in other orders,
  through up to 50 layers);
- one train step: the loss within ``1e-5`` relative; each parameter's
  update (after minus before) within ``1e-4`` of its tensor's largest
  update: it is the learning rate times a gradient through every
  BatchNorm's batch statistics, and each package's f32 gradient lies
  about ``1.5e-5`` of the largest gradient from an f64 one; the running
  statistics within ``1e-5`` (f32 means and variances of the same
  activations).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.models as RM
from paddle_tpu_torch import vision
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import Momentum


def _arrays(ref):
    return {k: np.asarray(v._value, np.float32)
            for k, v in ref.state_dict().items()}


def _stir_buffers(ref, seed):
    """Running statistics away from their 0 / 1 start."""
    rng = np.random.RandomState(seed)
    for name, b in ref.named_buffers():
        shape = tuple(b.shape)
        if name.endswith("_mean"):
            b._value = paddle.to_tensor(
                (0.1 * rng.randn(*shape)).astype(np.float32))._value
        elif name.endswith("_variance"):
            b._value = paddle.to_tensor(
                rng.uniform(0.5, 1.5, shape).astype(np.float32))._value


def _pair(ref_fn, port_fn, seed=0, stir=True, **kw):
    paddle.seed(seed)
    ref = ref_fn(**kw)
    if stir:
        _stir_buffers(ref, seed + 1)
    port = port_fn(device="cpu", **kw)
    vision.load_paddle_tpu_arrays(port, _arrays(ref))
    return ref, port


def _close_to_max(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("name,kw,shape", [
    ("resnet18", {}, (2, 3, 32, 32)),
    ("resnet50", {}, (2, 3, 32, 32)),
    ("LeNet", {}, (2, 1, 28, 28)),
    ("vgg11", dict(batch_norm=True, num_classes=10), (2, 3, 32, 32)),
    ("mobilenet_v2", dict(num_classes=10), (2, 3, 32, 32)),
])
def test_forward_matches_reference(name, kw, shape):
    ref, port = _pair(getattr(RM, name), getattr(vision.models, name), **kw)
    ref.eval()
    port.eval()
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = np.asarray(ref(paddle.to_tensor(x))._value)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    _close_to_max(got, want)


def test_resnet_keys_and_buffers_carry():
    ref, port = _pair(RM.resnet18, vision.models.resnet18)
    keys = set(port.state_dict())
    assert keys == set(ref.state_dict())
    assert "layer1.0.bn1._mean" in keys and "fc.weight" in keys
    np.testing.assert_array_equal(
        port.layer2[0].downsample[1]._variance.numpy(),
        np.asarray(ref.layer2[0].downsample[1]._variance._value))
    # a missing or extra key still raises
    arrays = _arrays(ref)
    arrays.pop("bn1._mean")
    with pytest.raises(KeyError, match="bn1._mean"):
        vision.load_paddle_tpu_arrays(port, arrays)


def test_resnet_pretrained_refused():
    with pytest.raises(NotImplementedError, match="pretrained"):
        vision.models.resnet50(pretrained=True, device="cpu")


def test_resnet18_momentum_step_matches_reference():
    """One eager step of scripts/bench_suite.py's resnet50_eager recipe
    (CrossEntropyLoss, Momentum(0.1)) on resnet18 at 4 x 3 x 64 x 64 (a
    2 x 2 map at layer4, so its BatchNorms see 16 values a channel):
    parameters and running statistics after the step equal the
    reference's."""
    ref, port = _pair(RM.resnet18, vision.models.resnet18, stir=False,
                      num_classes=10)
    before = {k: v.detach().clone().numpy()
              for k, v in port.state_dict().items()}
    rng = np.random.RandomState(4)
    x = rng.randn(4, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int64)

    ref_opt = paddle.optimizer.Momentum(0.1, parameters=ref.parameters())
    ref_loss = paddle.nn.CrossEntropyLoss()(ref(paddle.to_tensor(x)),
                                            paddle.to_tensor(y))
    ref_loss.backward()
    ref_opt.step()
    ref_opt.clear_grad()

    opt = Momentum(0.1, parameters=port.parameters())
    loss = CrossEntropyLoss()(port(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    opt.step()
    opt.clear_grad()

    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    want = vision.paddle_tpu_arrays_to_port(port, _arrays(ref))
    got = port.state_dict()
    for k, w in want.items():
        g = got[k].detach().numpy()
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            step = w - before[k]
            np.testing.assert_allclose(
                g - before[k], step, rtol=0,
                atol=1e-4 * float(np.abs(step).max()), err_msg=k)
    # the statistics moved by paddle's rule from their 0 / 1 start
    assert float(port.bn1._mean.abs().max()) > 0
    assert float((port.bn1._variance - 1).abs().max()) > 0
