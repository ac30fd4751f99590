"""The auto-parallel ``Engine`` of the port (counterpart of
``paddle_tpu/distributed/auto_parallel/engine.py``): ``fit``,
``evaluate``, ``predict``, ``save``, ``load``, ``history`` and
``main_program`` over one device.

The reference's Engine plans a mesh (by default data-parallel over every
device) and compiles its train step with GSPMD. The port runs the
one-rank path: no mesh or a ``ProcessMesh`` of one process, and a
``strategy`` whose parallel degrees are all 1. A larger mesh or degree
raises ``NotImplementedError`` naming ROADMAP A7. The train step is the
port's ``JittedTrainStep`` (eager forward, backward and the optimizer's
in-place update); ``evaluate`` and ``predict`` run the live module under
``torch.no_grad()`` in whatever train / eval mode it is in, as the
reference's jitted forward does.

Batches come from the port's ``io.DataLoader`` (``fit``'s drops its
partial last batch, as the reference's fixed-shape step needs; the
others keep it) and are moved to ``device`` (default ``cuda``; raises
without CUDA unless ``device="cpu"``), where the model's parameters must
lie.

Unlike the reference, ``load`` restores the optimizer's moments and step
count into the next ``fit`` (the port's state keys are structural, so
they match a rebuilt model's), and a resumed ``fit`` equals an
uninterrupted one (ROADMAP queue C).
"""
from __future__ import annotations

import os
import sys

import torch

from ..._device import resolve_device
from .api import check_one_rank

__all__ = ["Engine"]

_DEGREES = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
            "sep_degree")


def _check_strategy(strategy):
    """Raise ``NotImplementedError`` naming A7 for a parallel degree
    above 1 in ``strategy``'s ``hybrid_configs`` (or its sharding or
    tensor-parallel configs)."""
    hybrid = dict(getattr(strategy, "hybrid_configs", None) or {})
    degrees = {k: int(hybrid.get(k, 1) or 1) for k in _DEGREES}
    if getattr(strategy, "sharding", False):
        degrees["sharding_configs.degree"] = int(
            dict(getattr(strategy, "sharding_configs", {}) or {}).get(
                "degree", 1) or 1)
    if getattr(strategy, "tensor_parallel", False):
        degrees["tensor_parallel_degree"] = int(
            dict(getattr(strategy, "tensor_parallel_configs", {}) or {}).get(
                "tensor_parallel_degree", 1) or 1)
    above = {k: v for k, v in degrees.items() if v > 1}
    if above:
        raise NotImplementedError(
            f"Engine with parallel degrees {above} is not ported yet "
            f"(ROADMAP A7: the Engine's non-trivial strategy)")


def _to_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


class Engine:
    """Single-device train / eval / predict loop.

    Args:
        model: a ``torch.nn.Module`` whose parameters lie on ``device``.
        loss: ``loss(output, *labels)`` -> scalar loss tensor.
        optimizer: a port optimizer (needed by ``fit``).
        metrics: ``paddle_tpu_torch.metric.Metric``s for ``evaluate``.
        strategy: an object with ``hybrid_configs`` (a fleet
            ``DistributedStrategy``); every degree must be 1.
        mesh: None or a ``ProcessMesh`` of one process.
        device: where batches go (default ``cuda``).
    """

    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 strategy=None, mesh=None, device=None):
        if mesh is not None:
            check_one_rank(mesh, "Engine")
        if strategy is not None:
            _check_strategy(strategy)
        self._device = resolve_device(device)
        if model is not None:
            for name, p in model.named_parameters():
                if p.device.type != self._device.type:
                    raise ValueError(
                        f"Engine: parameter {name} lies on {p.device}, the "
                        f"engine runs on {self._device}")
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = list(metrics) if metrics else []
        self._train_step = None
        self._resume = False
        self._history = {}

    # -- paths ----------------------------------------------------------------
    def _ensure_train_step(self):
        if self._train_step is None:
            if self._optimizer is None or self._loss is None:
                raise ValueError("Engine.fit needs loss and optimizer")
            from ...jit.train import JittedTrainStep

            self._train_step = JittedTrainStep(self._model, self._loss,
                                               self._optimizer)
            if self._resume:
                self._train_step.resume_from_optimizer()
                self._resume = False
        return self._train_step

    def _forward(self, inputs):
        """The no-grad forward of the live module."""
        with torch.no_grad():
            return self._model(*inputs)

    def _to_device(self, xs):
        return [x.to(self._device, non_blocking=True)
                if isinstance(x, torch.Tensor)
                else torch.as_tensor(x, device=self._device) for x in xs]

    # -- data -----------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, drop_last=False):
        from ...io import DataLoader, Dataset

        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last)
        return data  # any iterable of (inputs, labels) batches

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) == 2:
                ins, lbs = batch
            else:
                ins, lbs = batch[0], batch[1:]
        else:
            ins, lbs = batch, []
        return self._to_device(_to_list(ins)), self._to_device(_to_list(lbs))

    # -- public API -----------------------------------------------------------
    def fit(self, train_data=None, valid_data=None, train_sample_split=None,
            batch_size=1, epochs=1, steps_per_epoch=None, log_freq=10,
            shuffle=True, verbose=1, collate_fn=None, callbacks=None,
            **kwargs):
        """Train for ``epochs`` over ``train_data``; returns the history:
        ``loss`` (each epoch's last step's) and, with ``valid_data``,
        ``val_<name>`` of each epoch's evaluation."""
        step = self._ensure_train_step()
        loader = self._loader(train_data, batch_size, shuffle,
                              drop_last=True)
        if loader is None:
            raise ValueError("Engine.fit: train_data is required")
        history = {"loss": []}
        for epoch in range(epochs):
            loss = None
            for i, batch in enumerate(loader):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                ins, lbs = self._split_batch(batch)
                loss = step(ins, lbs)
                if verbose and i % log_freq == 0:
                    print(f"[Engine] epoch {epoch} step {i} "
                          f"loss {float(loss):.6f}", file=sys.stderr)
            if loss is None:
                raise ValueError(
                    "Engine.fit: train_data produced no batches (dataset "
                    f"smaller than batch_size={batch_size}?)")
            history["loss"].append(float(loss))
            if valid_data is not None:
                for k, val in self.evaluate(valid_data, batch_size=batch_size,
                                            verbose=0).items():
                    history.setdefault("val_" + k, []).append(val)
        step.sync_to_model()
        self._history = history
        return history

    def evaluate(self, valid_data=None, valid_sample_split=None,
                 batch_size=1, steps=None, log_freq=10, verbose=1,
                 collate_fn=None, callbacks=None, **kwargs):
        """Mean loss over the batches (when the engine has a loss) and each
        metric's ``accumulate()`` under its ``name()``."""
        loader = self._loader(valid_data, batch_size, shuffle=False)
        if loader is None:
            raise ValueError("Engine.evaluate: valid_data is required")
        for m in self._metrics:
            m.reset()
        total, count = 0.0, 0
        for i, batch in enumerate(loader):
            if steps is not None and i >= steps:
                break
            ins, lbs = self._split_batch(batch)
            out = self._forward(ins)
            if self._loss is not None:
                with torch.no_grad():
                    total += float(self._loss(out, *lbs))
                count += 1
            for m in self._metrics:
                m.update(*[v.detach().cpu().numpy()
                           if isinstance(v, torch.Tensor) else v
                           for v in _leaves(m.compute(out, *lbs))])
        result = {}
        if count:
            result["loss"] = total / count
        for m in self._metrics:
            name = m.name() if callable(getattr(m, "name", None)) else "metric"
            result[name if isinstance(name, str) else str(name)] = \
                m.accumulate()
        if verbose:
            print(f"[Engine] eval {result}", file=sys.stderr)
        return result

    def predict(self, test_data=None, test_sample_split=None, batch_size=1,
                steps=None, verbose=0, collate_fn=None, callbacks=None,
                **kwargs):
        """The model's outputs, one entry a batch (the partial last batch
        kept), as tensors on the engine's device."""
        loader = self._loader(test_data, batch_size, shuffle=False)
        if loader is None:
            raise ValueError("Engine.predict: test_data is required")
        outputs = []
        for i, batch in enumerate(loader):
            if steps is not None and i >= steps:
                break
            ins, _ = self._split_batch(batch)
            outputs.append(_tree_map(lambda t: t.detach(),
                                     self._forward(ins)))
        return outputs

    def save(self, path, training=True):
        """``path.pdparams`` (the model's ``state_dict``) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        from ...framework.io import save

        if self._train_step is not None:
            self._train_step.sync_to_model()
        save(self._model.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, strict=True, load_optimizer=True):
        """Load ``path.pdparams`` into the model and, when present and
        asked for, ``path.pdopt`` into the optimizer; the next ``fit``
        starts from that optimizer state."""
        from ...framework.io import load

        self._model.load_state_dict(load(path + ".pdparams"), strict=strict)
        if load_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(load(path + ".pdopt"))
            self._resume = True
        self._train_step = None

    @property
    def main_program(self):
        """The reference's static program; there is none (None)."""
        return None

    @property
    def history(self):
        return self._history
