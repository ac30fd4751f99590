"""``paddle.metric`` of the port (counterpart of
``paddle_tpu/metric/__init__.py``): ``accuracy``, ``Metric``,
``Accuracy`` (top-k), ``Precision``, ``Recall`` and ``Auc``.
``Accuracy.compute`` and ``accuracy`` run on the predictions' device;
the accumulators are host numpy, as the reference's."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _topk_hits(logits, label, k):
    """(N, k) bool: whether the j-th largest logit's class is the
    label."""
    top = torch.topk(logits, k, dim=-1).indices
    lab = label if label.dim() == logits.dim() else label.unsqueeze(-1)
    return top == lab.to(top.device)


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """Share (0-d f32 tensor) of rows whose label is among the top ``k``
    logits."""
    hits = _topk_hits(_as_tensor(input), _as_tensor(label), k)
    return hits.any(dim=-1).float().mean()


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """(N, maxk) f32: 1 where the j-th best class is the label."""
        pred, label = _as_tensor(pred), _as_tensor(label)
        if label.dim() != 1:
            label = label.reshape(label.shape[0], -1)
        return _topk_hits(pred, label, self.maxk).float()

    def update(self, correct, *args):
        arr = _numpy(correct)
        num_samples = arr.shape[0]
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = arr[:, :k].sum()
            self.total[i] += num_corrects
            self.count[i] += num_samples
            accs.append(float(num_corrects) / num_samples)
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total,
                                                        self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of ``preds > 0.5`` against 0/1 labels."""

    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_pos = (_numpy(preds).reshape(-1) > 0.5).astype(np.int32)
        lab = _numpy(labels).reshape(-1).astype(np.int32)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fp += int(((pred_pos == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of ``preds > 0.5`` against 0/1 labels."""

    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_pos = (_numpy(preds).reshape(-1) > 0.5).astype(np.int32)
        lab = _numpy(labels).reshape(-1).astype(np.int32)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fn += int(((pred_pos == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC from ``num_thresholds + 1`` histogram bins of the positive
    probability (column 1 of (N, 2) predictions)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds, lab = _numpy(preds), _numpy(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bins = np.clip((pos_prob * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name
