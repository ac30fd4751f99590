"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``):
its 27 public functions, each with the reference's formula and options.
``cross_entropy`` computes in f32; the others in their inputs' dtype, as
the reference's do. Each casts its inputs under amp by the reference's op
name for it (most losses are black-listed: f32)."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ... import amp
from ...amp import amp_state

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "margin_ranking_loss",
    "cosine_embedding_loss", "hinge_embedding_loss", "sigmoid_focal_loss",
    "square_error_cost", "triplet_margin_loss", "ctc_loss",
    "soft_margin_loss", "multi_label_soft_margin_loss", "multi_margin_loss",
    "gaussian_nll_loss", "poisson_nll_loss", "hsigmoid_loss", "dice_loss",
    "log_loss", "npair_loss", "triplet_margin_with_distance_loss",
    "margin_cross_entropy",
]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy of ``input`` (logits, or probabilities with
    ``use_softmax=False``) over ``axis``, in f32 (op name
    ``cross_entropy``, black-listed by amp).

    Hard labels (integers, with or without a trailing 1 on ``axis``):
    ``label_smoothing`` mixes the picked log-probability with the mean
    over the classes; ``weight`` (one per class) scales each position's
    loss; positions whose label is ``ignore_index`` count neither in the
    sum nor in the mean's denominator, which is the sum of the live
    positions' weights, or their count (at least 1). Soft labels
    (``soft_label=True``, a distribution over ``axis``, smoothed towards
    uniform by ``label_smoothing``): ``-sum(label * log p)``, no weights.
    ``reduction`` is ``"mean"``, ``"sum"`` or ``"none"`` (per position, 0
    where ignored)."""
    if amp_state.enabled:
        input, label, weight = amp.cast_inputs_for_op("cross_entropy", input,
                                                  label, weight)
    x = input.float()
    logp = (torch.log_softmax(x, dim=axis) if use_softmax
            else torch.log(torch.clamp_min(x, 1e-30)))
    if soft_label:
        soft = label.float()
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) \
                + label_smoothing / input.shape[axis]
        return _reduce(-(soft * logp).sum(dim=axis), reduction)
    lab = label.squeeze(axis) if label.dim() == logp.dim() else label
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        picked = (1 - label_smoothing) * picked \
            + label_smoothing * logp.mean(dim=axis)
    loss = -picked
    w = None if weight is None else weight[safe]
    if w is not None:
        loss = loss * w
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        denom = (torch.where(valid, w, 0.0).sum() if w is not None
                 else valid.sum().float().clamp_min(1.0))
        return loss.sum() / denom
    return _reduce(loss, reduction)


def _cast(name, *tensors):
    """amp's rule for op ``name`` (its reference op name)."""
    if amp_state.enabled:
        return amp.cast_inputs_for_op(name, *tensors)
    return list(tensors)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-position cross entropy with the class axis kept (size 1);
    with ``return_softmax`` also the softmax."""
    out = cross_entropy(logits, label, soft_label=soft_label,
                        ignore_index=ignore_index, reduction="none",
                        axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax

        return out, softmax(logits, axis=axis)
    return out


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean", name=None):
    """Negative log likelihood of log-probabilities ``input`` (N, C, ...)
    at integer ``label`` (N, ...); weights and ``ignore_index`` as in
    :func:`cross_entropy`."""
    logp, label, weight = _cast("nll_loss", input, label, weight)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    loss = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    w = None if weight is None else weight[safe]
    if w is not None:
        loss = loss * w
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        denom = (torch.where(valid, w, 0.0).sum() if w is not None
                 else valid.sum().float().clamp_min(1.0))
        return loss.sum() / denom
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    a, b = _cast("mse_loss", input, label)
    return _reduce((a - b).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    a, b = _cast("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber: ``0.5 d^2`` where ``|d| < delta``, else
    ``delta (|d| - 0.5 delta)``."""
    a, b = _cast("smooth_l1", input, label)
    d = a - b
    loss = torch.where(d.abs() < delta, 0.5 * d * d,
                       delta * (d.abs() - 0.5 * delta))
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """BCE of probabilities, clipped to ``[1e-12, 1 - 1e-7]``."""
    p, y, w = _cast("bce", input, label, weight)
    p = torch.clamp(p, 1e-12, 1.0 - 1e-7)
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def _softplus_neg_abs(z):
    """``log(1 + exp(-|z|))``, as ``logaddexp(0, -|z|)``."""
    return torch.logaddexp(torch.zeros_like(z), -z.abs())


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """BCE of logits in the stable form ``max(z, 0) - z y + log(1 +
    exp(-|z|))``, ``pos_weight`` folded into the softplus term."""
    z, y, w, pw = _cast("bce_with_logits", logit, label, weight, pos_weight)
    if pw is not None:
        log_w = (pw - 1) * y + 1
        loss = (1 - y) * z + log_w * (_softplus_neg_abs(z)
                                      + torch.clamp_min(-z, 0.0))
    else:
        loss = torch.clamp_min(z, 0.0) - z * y + _softplus_neg_abs(z)
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """KL divergence of log-probabilities ``input`` from ``label``
    (probabilities, or log-probabilities with ``log_target``);
    ``reduction="batchmean"`` divides the sum by the batch."""
    logp, y = _cast("kl_div", input, label)
    if log_target:
        loss = torch.exp(y) * (y - logp)
    else:
        loss = y * (torch.log(torch.clamp_min(y, 1e-12)) - logp)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    a, b, y = _cast("margin_ranking_loss", input, other, label)
    return _reduce(torch.clamp_min(-y * (a - b) + margin, 0.0), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = _cast("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                             * torch.linalg.norm(b, dim=-1) + 1e-12)
    loss = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    x, y = _cast("hinge_embedding_loss", input, label)
    return _reduce(torch.where(y == 1, x, torch.clamp_min(margin - x, 0.0)),
                   reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    z, y, n = _cast("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0.0) - z * y + _softplus_neg_abs(z)
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if n is not None:
        loss = loss / n
    return _reduce(loss, reduction)


def square_error_cost(input, label):
    a, b = _cast("square_error_cost", input, label)
    return (a - b).square()


def _pdist(x, y, p, epsilon):
    return torch.pow(torch.pow((x - y).abs() + epsilon, p).sum(-1), 1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = _cast("triplet_margin_loss", input, positive, negative)
    dp, dn = _pdist(a, pos, p, epsilon), _pdist(a, neg, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _pdist(pos, neg, p, epsilon))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss of ``log_probs`` (T, B, C) against padded ``labels``
    (B, L). As the reference (which hands its input to optax's CTC, a
    log-softmax first), the input is normalized with a log-softmax over C,
    then the log-semiring forward recursion runs (PyTorch's CTC).
    ``norm_by_times`` divides each sequence's loss by its input length;
    ``"mean"`` divides each by its label length, then averages."""
    lp, lab, in_len, lab_len = _cast("ctc_loss", log_probs, labels,
                                     input_lengths, label_lengths)
    in_len, lab_len = in_len.long(), lab_len.long()
    per_seq = torch.nn.functional.ctc_loss(
        torch.log_softmax(lp.float(), dim=-1), lab.long(), in_len, lab_len,
        blank=blank, reduction="none").to(lp.dtype)
    if norm_by_times:
        per_seq = per_seq / torch.clamp_min(in_len.to(per_seq.dtype), 1)
    if reduction == "mean":
        per_seq = per_seq / torch.clamp_min(lab_len.to(per_seq.dtype), 1)
    return _reduce(per_seq, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    x, y = _cast("soft_margin_loss", input, label)
    nyx = -y * x
    return _reduce(torch.logaddexp(nyx, torch.zeros_like(nyx)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    x, y, w = _cast("multi_label_soft_margin_loss", input, label, weight)
    logsig = torch.nn.functional.logsigmoid
    loss = -(y * logsig(x) + (1 - y) * logsig(-x))
    if w is not None:
        loss = loss * w
    return _reduce(loss.mean(-1), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    x, y, w = _cast("multi_margin_loss", input, label, weight)
    c = x.shape[1]
    y = y.long()
    correct = x.gather(1, y[:, None])
    diff = torch.clamp_min(margin - correct + x, 0.0) ** p
    if w is not None:
        diff = diff * w[y][:, None]
    mask = torch.nn.functional.one_hot(y, c).to(x.dtype)
    return _reduce((diff * (1 - mask)).sum(-1) / c, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    mu, y, var = _cast("gaussian_nll_loss", input, label, variance)
    var = torch.clamp_min(var, epsilon)
    loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    x, y = _cast("poisson_nll_loss", input, label)
    if log_input:
        loss = torch.exp(x) - y * x
    else:
        loss = x - y * torch.log(torch.clamp_min(x, epsilon))
    if full:
        y1 = torch.clamp_min(y, 1.0)
        stirling = y * torch.log(y1) - y + 0.5 * torch.log(2 * math.pi * y1)
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce(loss, reduction)


@functools.lru_cache(maxsize=64)
def _hsigmoid_default_paths(num_classes):
    """Complete-binary-tree paths (heap layout): internal nodes 0 ..
    num_classes - 2 (root 0, children of i at 2i + 1 / 2i + 2), the leaf
    of class c at heap id num_classes - 1 + c. Returns (paths, codes) of
    shape (num_classes, depth), padded with -1; code 1 is a right
    child."""
    n = int(num_classes)
    depth = max(1, int(np.ceil(np.log2(max(n, 2)))))
    paths = -np.ones((n, depth), np.int64)
    codes = np.zeros((n, depth), np.int64)
    for c in range(n):
        node = n - 1 + c
        chain = []
        while node != 0:
            parent = (node - 1) // 2
            chain.append((parent, 1 if node == 2 * parent + 2 else 0))
            node = parent
        for j, (p, code) in enumerate(reversed(chain)):
            paths[c, j] = p
            codes[c, j] = code
    return paths, codes


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss: input (N, D), weight (num_classes - 1,
    D) over the default complete binary tree, or (num_nodes, D) with
    ``path_table`` / ``path_code`` (N, L; entries < 0 are padding). Each
    sample's loss sums BCE-with-logits over its path's nodes (code 1: a
    right child). Returns (N, 1) in input's dtype."""
    if path_table is not None and path_code is None:
        raise ValueError("hsigmoid_loss: path_table needs path_code")
    x, lab, w, b = _cast("hsigmoid_loss", input, label, weight, bias)
    lab_flat = lab.reshape(-1).long()
    if path_table is not None:
        nodes = path_table.long()
        codes = path_code.float()
    else:
        paths, codes_np = _hsigmoid_default_paths(num_classes)
        nodes = torch.from_numpy(paths).to(x.device)[lab_flat]
        codes = torch.from_numpy(codes_np).to(x.device)[lab_flat].float()
    valid = (nodes >= 0).float()
    safe = torch.clamp_min(nodes, 0)
    logits = torch.einsum("nd,nld->nl", x.float(), w[safe].float())
    if b is not None:
        logits = logits + b.reshape(-1).float()[safe]
    per_node = (torch.clamp_min(logits, 0.0) - logits * codes
                + torch.log1p(torch.exp(-logits.abs())))
    return (per_node * valid).sum(1, keepdim=True).to(x.dtype)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """input (N, ..., C) probabilities, label (N, ..., 1) class ids."""
    inp, lab = _cast("dice_loss", input, label)
    one_hot = torch.nn.functional.one_hot(
        lab[..., 0].long(), inp.shape[-1]).to(inp.dtype)
    dims = tuple(range(1, inp.dim()))
    inter = (inp * one_hot).sum(dims)
    union = inp.sum(dims) + one_hot.sum(dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4, name=None):
    """Binary cross entropy of raw probabilities, ``epsilon`` inside the
    logs; per element."""
    p, y = _cast("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1.0 - y) * torch.log(
        1.0 - p + epsilon)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    a, p, lab = _cast("npair_loss", anchor, positive, labels)
    lab = lab.reshape(-1, 1).to(a.dtype)
    same = (lab == lab.T).to(a.dtype)
    targets = same / same.sum(1, keepdim=True)
    logp = torch.log_softmax(a @ p.T, dim=1)
    ce = (-(targets * logp).sum(1)).mean()
    reg = l2_reg * ((a * a).sum(1).mean() + (p * p).sum(1).mean()) * 0.25
    return ce + reg


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """Triplet loss under ``distance_function(a, b)`` (default: the
    euclidean distance, ``sqrt(max(sum((a - b)^2), 1e-12))``)."""
    if distance_function is None:
        input, positive, negative = _cast(
            "triplet_margin_with_distance_loss", input, positive, negative)

        def distance_function(a, b):
            return torch.sqrt(torch.clamp_min(((a - b) ** 2).sum(-1),
                                              1e-12))
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-family margin softmax on one rank: ``cos(m1 theta + m2) -
    m3`` on the target class, times ``scale``, then cross entropy; the
    loss is (N, 1) before the reduction."""
    lg, lab = _cast("margin_cross_entropy", logits, label)
    one_hot = torch.nn.functional.one_hot(lab.reshape(-1).long(),
                                          lg.shape[1]).to(lg.dtype)
    cos = torch.clamp(lg, -1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    logp = torch.log_softmax(torch.where(one_hot > 0, target, cos) * scale,
                             dim=1)
    loss = -(one_hot * logp).sum(1, keepdim=True)
    if reduction in ("mean", "sum"):
        loss = _reduce(loss, reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss
