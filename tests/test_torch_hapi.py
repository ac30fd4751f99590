"""The port's ``metric``, ``hapi.Model``, callbacks and
``summary`` / ``flops`` held against paddle_tpu's on the CPU. LeNet is
built by the reference from its seed and carried with
``vision.load_paddle_tpu_arrays``; images and labels come from
``np.random.RandomState``.

Tolerances, each with its reason:
- metrics on the same predictions: equal, or ``1e-7`` relative for the
  float64 AUC and ``1e-6`` for the f32 mean of ``accuracy`` (one f32
  rounding);
- ``Model.fit``'s per-step losses and accuracies (amp off, Adam, no
  shuffle): losses ``1e-5`` relative, accuracies equal (counts of the
  same argmaxes; the logits agree to f32 rounding and the random data has
  no near-ties); ``evaluate`` ``1e-5`` relative; ``predict`` ``1e-5``
  absolute;
- parameter counts and ``flops``: equal.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as rmetric
from paddle_tpu.hapi.callbacks import Callback as RefCallback
from paddle_tpu.hapi.summary import flops as ref_flops
from paddle_tpu.hapi.summary import summary as ref_summary
from paddle_tpu.io import TensorDataset as RefTensorDataset
from paddle_tpu.vision.models import LeNet as RefLeNet
import paddle_tpu_torch
from paddle_tpu_torch import callbacks, metric
from paddle_tpu_torch.hapi import Model, flops, summary
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.vision import load_paddle_tpu_arrays
from paddle_tpu_torch.vision.models import LeNet


def _preds(seed=0, n=24, c=5):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, c)).astype(np.float32),
            rng.randint(0, c, (n,)).astype(np.int64))


def test_accuracy_matches_reference():
    logits, labels = _preds()
    for topk in ((1,), (1, 3)):
        acc, racc = metric.Accuracy(topk=topk), rmetric.Accuracy(topk=topk)
        for i in (0, 12):
            part = slice(i, i + 12)
            got = acc.update(acc.compute(torch.from_numpy(logits[part]),
                                         torch.from_numpy(labels[part])))
            want = racc.update(racc.compute(paddle.to_tensor(logits[part]),
                                            paddle.to_tensor(labels[part])))
            assert got == want
        assert acc.accumulate() == racc.accumulate()
        assert acc.name() == racc.name()
    np.testing.assert_allclose(
        float(metric.accuracy(torch.from_numpy(logits),
                              torch.from_numpy(labels[:, None]), k=2)),
        float(rmetric.accuracy(paddle.to_tensor(logits),
                               paddle.to_tensor(labels[:, None]), k=2)),
        rtol=1e-6)


def test_precision_recall_auc_match_reference():
    rng = np.random.RandomState(1)
    probs = rng.rand(40).astype(np.float32)
    labels = (rng.rand(40) > 0.5).astype(np.int64)
    two = np.stack([1 - probs, probs], axis=1)
    for cls, kw in ((metric.Precision, {}), (metric.Recall, {}),
                    (metric.Auc, {"num_thresholds": 255})):
        m, r = cls(**kw), getattr(rmetric, cls.__name__)(**kw)
        x = two if cls is metric.Auc else probs
        for part in (slice(0, 17), slice(17, 40)):
            m.update(torch.from_numpy(x[part]), torch.from_numpy(labels[part]))
            r.update(paddle.to_tensor(x[part]), paddle.to_tensor(labels[part]))
        np.testing.assert_allclose(m.accumulate(), r.accumulate(), rtol=1e-7)
        assert m.name() == r.name()
        m.reset()
        assert m.accumulate() == 0.0


def _data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, 1, 28, 28)).astype(np.float32),
            rng.randint(0, 4, (n, 1)).astype(np.int64))


class _Log(callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.steps = []

    def on_train_batch_end(self, step, logs=None):
        self.steps.append(dict(logs))


class _RefLog(RefCallback):
    def __init__(self):
        super().__init__()
        self.steps = []

    def on_train_batch_end(self, step, logs=None):
        self.steps.append(dict(logs))


def _lenet_pair(seed=0):
    paddle.seed(seed)
    ref = RefLeNet(num_classes=4)
    net = LeNet(num_classes=4, device="cpu")
    load_paddle_tpu_arrays(net, {k: np.asarray(v._value, np.float32)
                                 for k, v in ref.state_dict().items()})
    return ref, net


def test_lenet_fit_history_matches_reference(tmp_path):
    ref, net = _lenet_pair()
    x, y = _data(16)
    rmodel = paddle.Model(ref)
    rmodel.prepare(paddle.optimizer.Adam(0.01, parameters=ref.parameters()),
                   paddle.nn.CrossEntropyLoss(), rmetric.Accuracy())
    model = Model(net, device="cpu")
    model.prepare(Adam(0.01, parameters=net.parameters()),
                  CrossEntropyLoss(), metric.Accuracy())
    rlog, log = _RefLog(), _Log()
    rmodel.fit(RefTensorDataset([x, y]), epochs=2, batch_size=8,
               shuffle=False, verbose=0, callbacks=[rlog])
    model.fit(TensorDataset([x, y]), epochs=2, batch_size=8, shuffle=False,
              verbose=0, callbacks=[log])
    assert len(log.steps) == len(rlog.steps) == 4
    np.testing.assert_allclose([s["loss"] for s in log.steps],
                               [s["loss"] for s in rlog.steps], rtol=1e-5)
    assert [s["acc"] for s in log.steps] == [s["acc"] for s in rlog.steps]
    got = model.evaluate(TensorDataset([x, y]), batch_size=8, verbose=0)
    want = rmodel.evaluate(RefTensorDataset([x, y]), batch_size=8,
                           verbose=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["acc"] == want["acc"]
    out = model.predict(TensorDataset([x]), batch_size=8,
                        stack_outputs=True)
    rout = rmodel.predict(RefTensorDataset([x]), batch_size=8,
                          stack_outputs=True)
    np.testing.assert_allclose(out[0], rout[0], atol=1e-5)
    # save -> load round trip, optimizer state included
    path = str(tmp_path / "lenet")
    model.save(path)
    w = net.features[0].weight.detach().clone()
    with torch.no_grad():
        net.features[0].weight.zero_()
    model.load(path)
    torch.testing.assert_close(net.features[0].weight, w, rtol=0, atol=0)
    assert os.path.exists(path + ".pdopt")
    again = model.evaluate(TensorDataset([x, y]), batch_size=8, verbose=0)
    assert again == got


def test_callbacks_checkpoint_early_stop_schedule_visualdl(tmp_path):
    _, net = _lenet_pair(seed=1)
    x, y = _data(16, seed=2)
    sched = StepDecay(0.1, step_size=1, gamma=0.5)
    model = Model(net, device="cpu").prepare(
        SGD(sched, parameters=net.parameters()), CrossEntropyLoss(),
        metric.Accuracy())
    stop = callbacks.EarlyStopping(monitor="loss", patience=0,
                                   min_delta=1e9)
    vdl = callbacks.VisualDL(str(tmp_path / "vdl"))
    model.fit(TensorDataset([x, y]), eval_data=TensorDataset([x, y]),
              epochs=5, batch_size=8, verbose=0, save_dir=str(tmp_path),
              callbacks=[stop, vdl])
    # the first evaluation sets the best loss, the second cannot beat it by
    # 1e9 and stops the run
    assert sorted(os.listdir(tmp_path)) == ["0.pdopt", "0.pdparams",
                                            "1.pdopt", "1.pdparams",
                                            "final.pdopt", "final.pdparams",
                                            "vdl"]
    assert sched.last_epoch == 4  # stepped after each of 4 batches
    from paddle_tpu_torch.visualdl import LogReader

    assert len(LogReader(str(tmp_path / "vdl")).scalars("train/loss")) == 4
    nan = callbacks.Terminate()
    model.stop_training = False
    nan.set_model(model)
    nan.on_train_batch_end(0, {"loss": float("nan")})
    assert model.stop_training
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            Model(net)


def test_amp_prepare_runs_under_auto_cast():
    _, net = _lenet_pair(seed=2)
    x, y = _data(8, seed=3)
    model = Model(net, device="cpu").prepare(
        Adam(1e-3, parameters=net.parameters()), CrossEntropyLoss(),
        amp_configs={"level": "O1", "dtype": "bfloat16"})
    assert not model._scaler.is_enable()  # bf16: no loss scaling
    loss = model.train_batch([x], [y])
    assert np.isfinite(loss[0])
    fp16 = Model(net, device="cpu").prepare(
        Adam(1e-3, parameters=net.parameters()), CrossEntropyLoss(),
        amp_configs={"level": "O1", "init_loss_scaling": 64.0})
    assert fp16._scaler.is_enable() and fp16._scaler.get_loss_scaling() == 64


def test_summary_and_flops_match_reference():
    ref, net = _lenet_pair(seed=3)
    assert summary(net) == ref_summary(ref)
    assert flops(net, [1, 1, 28, 28]) == ref_flops(ref, [1, 1, 28, 28])
    assert flops(net, [2, 1, 28, 28]) == ref_flops(ref, [2, 1, 28, 28])
    mlp = paddle_tpu_torch.nn.Sequential(paddle_tpu_torch.nn.Linear(8, 16),
                                         paddle_tpu_torch.nn.ReLU(),
                                         paddle_tpu_torch.nn.Linear(16, 3))
    rmlp = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 3))
    assert flops(mlp, [4, 8]) == ref_flops(rmlp, [4, 8])
    assert paddle_tpu_torch.Model is Model and paddle_tpu_torch.flops is flops
