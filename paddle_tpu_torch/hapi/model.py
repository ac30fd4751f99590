"""``paddle.Model`` of the port (counterpart of
``paddle_tpu/hapi/model.py``): ``prepare``, ``train_batch``,
``eval_batch``, ``predict_batch``, ``fit``, ``evaluate``, ``predict``,
``save`` and ``load`` over a ``torch.nn.Module``.

The loop is the reference's: eager forward, ``loss(*outputs, *labels)``,
backward and the optimizer's ``step`` / ``clear_grad``, metrics through
``compute`` then ``update``. ``amp_configs`` (a level string or a dict
with ``level``, ``dtype`` and the ``GradScaler`` knobs) runs the forward
under the port's ``amp.auto_cast`` and scales the loss with its
``GradScaler`` for float16 (bfloat16 needs no scaling). Batches move to
``device`` (default ``cuda``; raises without CUDA unless
``device="cpu"``), where the network's parameters must lie.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device
from .callbacks import CallbackList, config_callbacks

__all__ = ["Model"]

_SCALER_KEYS = ("init_loss_scaling", "incr_ratio", "decr_ratio",
                "incr_every_n_steps", "decr_every_n_nan_or_inf",
                "use_dynamic_loss_scaling")


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        self._device = resolve_device(device)
        for name, p in network.named_parameters():
            if p.device.type != self._device.type:
                raise ValueError(
                    f"Model: parameter {name} lies on {p.device}, the model "
                    f"runs on {self._device}")
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._scaler = None
        self._amp_level = None
        self._amp_dtype = "float16"
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        from .. import amp

        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._amp_level = None
        self._amp_dtype = "float16"
        self._scaler = None
        if amp_configs is not None:
            if isinstance(amp_configs, dict):
                self._amp_level = amp_configs.get("level", "O1")
                self._amp_dtype = amp_configs.get("dtype", "float16")
                scaler_kwargs = {k: v for k, v in amp_configs.items()
                                 if k in _SCALER_KEYS}
            else:
                self._amp_level = amp_configs
                scaler_kwargs = {}
            self._scaler = amp.GradScaler(
                enable=self._amp_dtype == "float16", **scaler_kwargs)
        return self

    def _tensors(self, xs):
        return [x.to(self._device) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=self._device)
                for x in _to_list(xs)]

    def _metric_updates(self, outputs, labels):
        out = []
        for metric in self._metrics:
            res = metric.compute(*(outputs + labels))
            out.append(metric.update(*_to_list(res)))
        return out

    # -- single batch ---------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One step; returns the loss values (and the metrics' updates)."""
        from .. import amp

        self.network.train()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        if self._amp_level:
            with amp.auto_cast(level=self._amp_level, dtype=self._amp_dtype):
                outputs = _to_list(self.network(*inputs))
                losses = _to_list(self._loss(*(outputs + labels)))
        else:
            outputs = _to_list(self.network(*inputs))
            losses = _to_list(self._loss(*(outputs + labels)))
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        if self._scaler is not None and self._scaler.is_enable():
            self._scaler.scale(total).backward()
            if update and self._optimizer is not None:
                self._scaler.step(self._optimizer)
                self._scaler.update()
                self._optimizer.clear_grad()
        else:
            total.backward()
            if update and self._optimizer is not None:
                self._optimizer.step()
                self._optimizer.clear_grad()
        with torch.no_grad():
            metrics = self._metric_updates([o.detach() for o in outputs],
                                           labels)
        loss_vals = [float(v.detach()) for v in losses]
        return (loss_vals, metrics) if metrics else loss_vals

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        outputs = _to_list(self.network(*inputs))
        loss_vals = []
        if self._loss is not None and labels:
            loss_vals = [float(v) for v in _to_list(
                self._loss(*(outputs + labels)))]
        metrics = self._metric_updates(outputs, labels)
        return (loss_vals, metrics) if metrics else loss_vals

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs as numpy arrays."""
        self.network.eval()
        outputs = self.network(*self._tensors(inputs))
        return [o.detach().cpu().numpy() for o in _to_list(outputs)]

    # -- loops ----------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, drop_last=False,
                     num_workers=0):
        from ..io import DataLoader

        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def _split(self, batch, n_default):
        batch = _to_list(batch)
        n_in = len(self._inputs) if self._inputs else n_default(batch)
        return batch[:n_in], batch[n_in:]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        train_loader = self._make_loader(train_data, batch_size, shuffle,
                                         drop_last, num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=[m.name() for m in self._metrics])
        self.stop_training = False
        cbks.on_train_begin()
        it_count = 0
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                ins, labs = self._split(batch, lambda b: len(b) - 1)
                result = self.train_batch(ins, labs)
                loss_vals = result[0] if isinstance(result, tuple) else result
                logs = {"loss": loss_vals[0]}
                for m in self._metrics:
                    logs[str(m.name())] = m.accumulate()
                cbks.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters and it_count >= num_iters:
                    self.stop_training = True  # ends the epoch loop too
                if self.stop_training:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=verbose, callbacks=cbks)
            if self.stop_training:
                break
        cbks.on_train_end()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """Mean loss over the batches and each metric's ``accumulate()``."""
        loader = self._make_loader(eval_data, batch_size, False,
                                   num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        cbks = (callbacks if isinstance(callbacks, CallbackList)
                else config_callbacks(callbacks, model=self,
                                      verbose=verbose))
        cbks.on_eval_begin()
        total_loss, n = 0.0, 0
        for batch in loader:
            ins, labs = self._split(batch, lambda b: len(b) - 1)
            result = self.eval_batch(ins, labs)
            loss_vals = result[0] if isinstance(result, tuple) else result
            if loss_vals:
                total_loss += loss_vals[0]
                n += 1
        logs = {"loss": total_loss / max(n, 1)}
        for m in self._metrics:
            logs[str(m.name())] = m.accumulate()
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Each batch's outputs (numpy), or with ``stack_outputs`` each
        output concatenated over the batches."""
        loader = self._make_loader(test_data, batch_size, False,
                                   num_workers=num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split(batch, len)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence ----------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` and, with ``training``, ``path.pdopt``."""
        from ..framework.io import save as psave

        psave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as pload

        self.network.load_state_dict(pload(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(pload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary

        return _summary(self.network, input_size, dtype)
