"""hapi callbacks of the port (counterpart of
``paddle_tpu/hapi/callbacks.py``): the ``Callback`` protocol,
``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler`` (steps the optimizer's schedule),
``Terminate`` (stops on a non-finite loss), ``VisualDL`` (scalars to the
port's ``visualdl.LogWriter``) and ``config_callbacks``. Host code; the
model they drive is ``hapi.Model``."""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = [
    "Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
    "LRScheduler", "Terminate", "VisualDL", "config_callbacks",
    "CallbackList",
]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kwargs)

            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose == 2 and step % self.log_freq == 0:
            metrics = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in logs.items()
            )
            print(f"step {step}/{self.steps or '?'} - {metrics}")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.verbose:
            dur = time.time() - self._start
            metrics = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in logs.items()
            )
            print(f"Epoch {epoch + 1} done in {dur:.1f}s - {metrics}")

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            metrics = " - ".join(
                f"{k}: {v}" for k, v in logs.items() if k != "batch_size"
            )
            print(f"Eval - {metrics}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"{epoch}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.monitor_op = np.greater
            self.min_delta *= 1
        else:
            self.monitor_op = np.less
            self.min_delta *= -1
        self.best = None
        self.wait = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple, np.ndarray)):
            value = value[0]
        if self.best is None or self.monitor_op(value - self.min_delta, self.best):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step, self.by_epoch = by_step, by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched

        if opt is not None and isinstance(opt._lr, Sched):
            return opt._lr
        return None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class Terminate(Callback):
    """Terminates on NaN loss (paddle's TerminateOnNaN analog)."""

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        loss = logs.get("loss")
        if loss is not None and not np.all(np.isfinite(loss)):
            self.model.stop_training = True


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    })
    return lst


class VisualDL(Callback):
    """Streams train/eval scalars to a VisualDL LogWriter
    (reference: paddle.callbacks.VisualDL)."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._train_step = 0

    def _w(self):
        if self._writer is None:
            from ..visualdl import LogWriter

            self._writer = LogWriter(logdir=self.log_dir)
        return self._writer

    def _log_all(self, prefix, step, logs):
        for k, v in (logs or {}).items():
            try:
                self._w().add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass  # non-scalar entries (e.g. batch size lists)

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        self._log_all("train", self._train_step, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._log_all("train_epoch", epoch, logs)

    def on_eval_end(self, logs=None):
        self._log_all("eval", self._train_step, logs)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
