"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``): the
reference's 21 layers, each holding its options and calling its
functional (``nn/functional/loss.py``)."""
from __future__ import annotations

import torch

from .. import functional as F
from ..functional import loss as L
from .layers import Layer

__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "HingeEmbeddingLoss", "TripletMarginLoss",
    "SigmoidFocalLoss", "CTCLoss", "SoftMarginLoss",
    "MultiLabelSoftMarginLoss", "MultiMarginLoss", "GaussianNLLLoss",
    "PoissonNLLLoss", "PairwiseDistance", "HSigmoidLoss",
]


class _Loss(Layer):
    """A loss layer: ``fn(*inputs, **options)``."""

    fn = None

    def __init__(self, **options):
        super().__init__()
        self._args = options

    def forward(self, *inputs):
        return type(self).fn(*inputs, **self._args)


class CrossEntropyLoss(_Loss):
    fn = staticmethod(F.cross_entropy)

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax,
                         label_smoothing=label_smoothing)


class MSELoss(_Loss):
    fn = staticmethod(L.mse_loss)

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class L1Loss(_Loss):
    fn = staticmethod(L.l1_loss)

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class NLLLoss(_Loss):
    fn = staticmethod(L.nll_loss)

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)


class BCELoss(_Loss):
    fn = staticmethod(L.binary_cross_entropy)

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    fn = staticmethod(L.binary_cross_entropy_with_logits)

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)


class KLDivLoss(_Loss):
    fn = staticmethod(L.kl_div)

    def __init__(self, reduction="mean", log_target=False):
        super().__init__(reduction=reduction, log_target=log_target)


class SmoothL1Loss(_Loss):
    fn = staticmethod(L.smooth_l1_loss)

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class MarginRankingLoss(_Loss):
    fn = staticmethod(L.margin_ranking_loss)

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CosineEmbeddingLoss(_Loss):
    fn = staticmethod(L.cosine_embedding_loss)

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class HingeEmbeddingLoss(_Loss):
    fn = staticmethod(L.hinge_embedding_loss)

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class TripletMarginLoss(_Loss):
    fn = staticmethod(L.triplet_margin_loss)

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)


class SigmoidFocalLoss(_Loss):
    fn = staticmethod(L.sigmoid_focal_loss)

    def __init__(self, alpha=0.25, gamma=2.0, reduction="sum", name=None):
        super().__init__(alpha=alpha, gamma=gamma, reduction=reduction)

    def forward(self, logit, label, normalizer=None):
        return L.sigmoid_focal_loss(logit, label, normalizer, **self._args)


class CTCLoss(_Loss):
    fn = staticmethod(L.ctc_loss)

    def __init__(self, blank=0, reduction="mean"):
        super().__init__(blank=blank, reduction=reduction)

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return L.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          norm_by_times=norm_by_times, **self._args)


class SoftMarginLoss(_Loss):
    fn = staticmethod(L.soft_margin_loss)

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class MultiLabelSoftMarginLoss(_Loss):
    fn = staticmethod(L.multi_label_soft_margin_loss)

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class MultiMarginLoss(_Loss):
    fn = staticmethod(L.multi_margin_loss)

    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(p=p, margin=margin, weight=weight,
                         reduction=reduction)


class GaussianNLLLoss(_Loss):
    fn = staticmethod(L.gaussian_nll_loss)

    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(full=full, epsilon=epsilon, reduction=reduction)


class PoissonNLLLoss(_Loss):
    fn = staticmethod(L.poisson_nll_loss)

    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(log_input=log_input, full=full, epsilon=epsilon,
                         reduction=reduction)


class PairwiseDistance(Layer):
    """``|x - y + epsilon|_p`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p,
                                        dim=-1, keepdim=self.keepdim)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree
    (``is_custom=False``) or caller-supplied ``path_table`` /
    ``path_code``; holds the (num_classes - 1, feature_size) node weight
    (Xavier-normal, the reference's default) and bias (zeros)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, device=None, generator=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self._num_classes = num_classes
        self._is_custom = is_custom
        w = torch.empty(num_classes - 1, feature_size, device=device)
        std = (2.0 / (num_classes - 1 + feature_size)) ** 0.5
        self.weight = torch.nn.Parameter(w.normal_(0.0, std,
                                                   generator=generator))
        self.bias = torch.nn.Parameter(torch.zeros(num_classes - 1,
                                                   device=device))

    def forward(self, input, label, path_table=None, path_code=None):
        if self._is_custom and (path_table is None or path_code is None):
            raise ValueError(
                "is_custom HSigmoidLoss needs path_table and path_code")
        return L.hsigmoid_loss(
            input, label, self._num_classes, self.weight, bias=self.bias,
            path_table=path_table if self._is_custom else None,
            path_code=path_code if self._is_custom else None)
