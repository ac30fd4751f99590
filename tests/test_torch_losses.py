"""The port's loss functionals and layers (``paddle_tpu_torch.nn``) and
``F.rms_norm``'s weightless and biased variants held against
paddle_tpu's, on seeded numpy inputs, in f32.

Tolerances, each with its reason:
- ``1e-6`` relative and absolute: the same f32 formula on both sides,
  whose elementwise kernels may differ in the last bit;
- ``ctc_loss``: ``1e-5`` relative: the reference runs optax's CTC
  recursion (a log-softmax, then a scan in the log semiring), the port
  PyTorch's, which sums the same paths in another order;
- ``hsigmoid_loss`` and ``npair_loss``: ``1e-5``: an einsum / matmul over
  the feature axis, summed in another order.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as ref_nn
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch.nn as port_nn
from paddle_tpu_torch.nn import functional as PF

R = np.random.RandomState(0)


def _f(*shape, lo=None, hi=None, seed=None):
    r = np.random.RandomState(seed) if seed is not None else R
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def _both(arrays):
    """(reference tensors, port tensors) of one numpy list."""
    ref = [None if a is None else paddle.to_tensor(a) for a in arrays]
    port = [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]
    return ref, port


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _check(name, ref_fn, port_fn, arrays, tol=1e-6, **kw):
    """Both functions on the same arrays; numpy keyword values go in as
    each side's tensors."""
    ref, port = _both(arrays)
    arr = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    ref_kw = dict(kw, **dict(zip(arr, _both(list(arr.values()))[0])))
    port_kw = dict(kw, **dict(zip(arr, _both(list(arr.values()))[1])))
    want = ref_fn(*ref, **ref_kw)
    got = port_fn(*port, **port_kw)
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol,
                                       err_msg=name)
    else:
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                                   err_msg=name)


LOGITS = _f(6, 5)
HARD = np.array([0, 3, -100, 4, 1, 2], np.int64)
SOFT = np.exp(_f(6, 5)) / np.exp(_f(6, 5)).sum(-1, keepdims=True)
CLASS_W = _f(5, lo=0.2, hi=1.5)
PROBS = _f(4, 6, lo=0.01, hi=0.99)
BIN = (R.rand(4, 6) > 0.5).astype(np.float32)
PM1 = np.where(R.rand(4) > 0.5, 1.0, -1.0).astype(np.float32)

CASES = {
    # cross_entropy with its options
    "ce_hard": ("cross_entropy", [LOGITS, HARD], {}),
    "ce_hard_sum": ("cross_entropy", [LOGITS, HARD], dict(reduction="sum")),
    "ce_hard_none": ("cross_entropy", [LOGITS, HARD],
                     dict(reduction="none")),
    "ce_weight": ("cross_entropy", [LOGITS, HARD, CLASS_W], {}),
    "ce_weight_none": ("cross_entropy", [LOGITS, HARD, CLASS_W],
                       dict(reduction="none")),
    "ce_smoothing": ("cross_entropy", [LOGITS, HARD],
                     dict(label_smoothing=0.1)),
    "ce_soft": ("cross_entropy", [LOGITS, SOFT], dict(soft_label=True)),
    "ce_soft_smoothing": ("cross_entropy", [LOGITS, SOFT],
                          dict(soft_label=True, label_smoothing=0.2,
                               reduction="sum")),
    "ce_axis0": ("cross_entropy", [_f(5, 6), np.array([0, 1, 4, 2, 3, 3])],
                 dict(axis=0)),
    "ce_no_softmax": ("cross_entropy", [SOFT, HARD],
                      dict(use_softmax=False)),
    "ce_trailing_label": ("cross_entropy",
                          [LOGITS, HARD.clip(0)[:, None]], {}),
    "ce_3d": ("cross_entropy", [_f(2, 3, 5),
                                np.array([[0, 1, 2], [3, 4, -100]])], {}),
    "nll": ("nll_loss", [np.log(SOFT), HARD], {}),
    "nll_weight_sum": ("nll_loss", [np.log(SOFT), HARD, CLASS_W],
                       dict(reduction="sum")),
    "nll_weight_mean": ("nll_loss", [np.log(SOFT), HARD, CLASS_W], {}),
    "mse": ("mse_loss", [_f(3, 4), _f(3, 4)], {}),
    "mse_none": ("mse_loss", [_f(3, 4), _f(3, 4)], dict(reduction="none")),
    "l1_sum": ("l1_loss", [_f(3, 4), _f(3, 4)], dict(reduction="sum")),
    "smooth_l1": ("smooth_l1_loss", [_f(3, 4), _f(3, 4)], dict(delta=0.5)),
    "bce": ("binary_cross_entropy", [PROBS, BIN], {}),
    "bce_weight_none": ("binary_cross_entropy",
                        [PROBS, BIN, _f(6, lo=0.5, hi=1.0)],
                        dict(reduction="none")),
    "bce_logits": ("binary_cross_entropy_with_logits", [_f(4, 6) * 3, BIN],
                   {}),
    "bce_logits_pos_weight": ("binary_cross_entropy_with_logits",
                              [_f(4, 6) * 3, BIN],
                              dict(pos_weight=_f(6, lo=0.5, hi=2.0),
                                   weight=_f(6, lo=0.5, hi=1.0),
                                   reduction="sum")),
    "kl": ("kl_div", [np.log(SOFT), SOFT[::-1].copy()], {}),
    "kl_batchmean": ("kl_div", [np.log(SOFT), SOFT[::-1].copy()],
                     dict(reduction="batchmean")),
    "kl_log_target": ("kl_div", [np.log(SOFT), np.log(SOFT[::-1].copy())],
                      dict(log_target=True, reduction="sum")),
    "margin_ranking": ("margin_ranking_loss", [_f(4), _f(4), PM1],
                       dict(margin=0.3)),
    "cosine_embedding": ("cosine_embedding_loss", [_f(4, 6), _f(4, 6), PM1],
                         dict(margin=0.1)),
    "hinge_embedding": ("hinge_embedding_loss", [_f(4, 6), BIN * 2 - 1],
                        dict(margin=0.8)),
    "focal": ("sigmoid_focal_loss", [_f(4, 6) * 2, BIN], {}),
    "focal_normalizer_mean": ("sigmoid_focal_loss",
                              [_f(4, 6) * 2, BIN,
                               np.array([3.0], np.float32)],
                              dict(reduction="mean", gamma=1.5)),
    "square_error": ("square_error_cost", [_f(3, 4), _f(3, 4)], {}),
    "triplet": ("triplet_margin_loss", [_f(4, 6), _f(4, 6), _f(4, 6)], {}),
    "triplet_swap_p1": ("triplet_margin_loss",
                        [_f(4, 6), _f(4, 6), _f(4, 6)],
                        dict(p=1.0, swap=True, reduction="none")),
    "soft_margin": ("soft_margin_loss", [_f(4, 6), BIN * 2 - 1], {}),
    "multi_label_soft_margin": ("multi_label_soft_margin_loss",
                                [_f(4, 6), BIN, _f(6, lo=0.5, hi=1.0)], {}),
    "multi_margin": ("multi_margin_loss",
                     [_f(4, 5), np.array([0, 2, 4, 1])], {}),
    "multi_margin_p2_weight": ("multi_margin_loss",
                               [_f(4, 5), np.array([0, 2, 4, 1])],
                               dict(p=2, margin=0.7,
                                    weight=_f(5, lo=0.5, hi=1.5),
                                    reduction="sum")),
    "gaussian_nll": ("gaussian_nll_loss",
                     [_f(4, 3), _f(4, 3), _f(4, 3, lo=0.1, hi=2.0)], {}),
    "gaussian_nll_full": ("gaussian_nll_loss",
                          [_f(4, 3), _f(4, 3), _f(4, 3, lo=0.1, hi=2.0)],
                          dict(full=True, reduction="sum")),
    "poisson_nll": ("poisson_nll_loss",
                    [_f(4, 3), _f(4, 3, lo=0.0, hi=4.0)], {}),
    "poisson_nll_full_raw": ("poisson_nll_loss",
                             [_f(4, 3, lo=0.1, hi=3.0),
                              _f(4, 3, lo=0.0, hi=4.0)],
                             dict(log_input=False, full=True,
                                  reduction="none")),
    "dice": ("dice_loss", [SOFT.reshape(2, 3, 5),
                           np.array([[[0], [3], [4]], [[1], [2], [2]]])],
             {}),
    "log_loss": ("log_loss", [PROBS, BIN], {}),
    "npair": ("npair_loss", [_f(4, 6), _f(4, 6),
                             np.array([0, 1, 0, 2], np.float32)], {}),
    "triplet_distance": ("triplet_margin_with_distance_loss",
                         [_f(4, 6), _f(4, 6), _f(4, 6)],
                         dict(swap=True, margin=0.5)),
    "margin_ce": ("margin_cross_entropy",
                  [np.tanh(_f(4, 5)), np.array([0, 3, 1, 4])], {}),
    "margin_ce_none": ("margin_cross_entropy",
                       [np.tanh(_f(4, 5)), np.array([0, 3, 1, 4])],
                       dict(reduction="none", margin2=0.3, scale=8.0)),
}
LOOSE = {"npair": 1e-5}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_function_matches_reference(case):
    name, arrays, kw = CASES[case]
    _check(case, getattr(RF, name), getattr(PF, name), arrays,
           tol=LOOSE.get(case, 1e-6), **kw)


def test_every_reference_loss_is_ported():
    from paddle_tpu.nn.functional import loss as ref_loss
    from paddle_tpu.nn.layer import loss as ref_layers

    assert sorted(PF.loss.__all__) == sorted(ref_loss.__all__)
    assert len(PF.loss.__all__) == 27
    assert sorted(port_nn.layer.loss.__all__) == sorted(ref_layers.__all__)
    assert len(port_nn.layer.loss.__all__) == 21


def test_softmax_with_cross_entropy_matches_reference():
    ref, port = _both([LOGITS, HARD.clip(0)])
    want_l, want_s = RF.softmax_with_cross_entropy(ref[0], ref[1],
                                                   return_softmax=True)
    got_l, got_s = PF.softmax_with_cross_entropy(port[0], port[1],
                                                 return_softmax=True)
    np.testing.assert_allclose(_np(got_l), _np(want_l), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=1e-6,
                               atol=1e-6)
    assert tuple(got_l.shape) == (6, 1)


def test_margin_cross_entropy_return_softmax_matches_reference():
    arrays = [np.tanh(_f(4, 5)), np.array([0, 3, 1, 4])]
    _check("margin_ce_softmax", RF.margin_cross_entropy,
           PF.margin_cross_entropy, arrays, return_softmax=True)


def test_triplet_with_custom_distance_matches_reference():
    a, p, n = _f(4, 6), _f(4, 6), _f(4, 6)
    ref, port = _both([a, p, n])
    want = RF.triplet_margin_with_distance_loss(
        *ref, distance_function=lambda x, y: ((x - y).abs()).sum(-1),
        swap=True)
    got = PF.triplet_margin_with_distance_loss(
        *port, distance_function=lambda x, y: ((x - y).abs()).sum(-1),
        swap=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction,norm_by_times",
                         [("mean", False), ("sum", False), ("none", True)])
def test_ctc_loss_matches_reference(reduction, norm_by_times):
    t, b, c = 12, 3, 6
    log_probs = torch.log_softmax(torch.from_numpy(_f(t, b, c, seed=9)),
                                  -1).numpy()
    labels = np.array([[1, 2, 2, 3], [4, 1, 0, 0], [5, 5, 3, 0]],
                      np.int32)
    in_len = np.array([12, 9, 11], np.int32)
    lab_len = np.array([4, 2, 3], np.int32)
    _check("ctc", RF.ctc_loss, PF.ctc_loss,
           [log_probs, labels, in_len, lab_len], tol=1e-5,
           reduction=reduction, norm_by_times=norm_by_times)


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_loss_matches_reference(custom):
    n, d, k = 5, 4, 6
    x = _f(n, d, seed=11)
    lab = np.array([0, 5, 2, 3, 1])
    if custom:
        table = np.array([[0, 2, -1], [0, 1, 3], [1, 4, -1], [0, -1, -1],
                          [2, 3, 4]])
        code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0],
                         [1, 0, 1]])
        w, bias = _f(6, d, seed=12), _f(6, seed=13)
        arrays = [x, lab, w, bias, table, code]
    else:
        w, bias = _f(k - 1, d, seed=12), _f(k - 1, seed=13)
        arrays = [x, lab, w, bias]
    ref, port = _both(arrays)

    def call(F, t):
        if custom:
            return F.hsigmoid_loss(t[0], t[1], k, t[2], bias=t[3],
                                   path_table=t[4], path_code=t[5])
        return F.hsigmoid_loss(t[0], t[1], k, t[2], bias=t[3])

    want, got = call(RF, ref), call(PF, port)
    assert tuple(got.shape) == (n, 1)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


LAYERS = {
    "CrossEntropyLoss": (dict(label_smoothing=0.1), [LOGITS, HARD]),
    "MSELoss": (dict(reduction="sum"), [_f(3, 4), _f(3, 4)]),
    "L1Loss": ({}, [_f(3, 4), _f(3, 4)]),
    "NLLLoss": (dict(ignore_index=-100), [np.log(SOFT), HARD]),
    "BCELoss": ({}, [PROBS, BIN]),
    "BCEWithLogitsLoss": ({}, [_f(4, 6), BIN]),
    "KLDivLoss": (dict(reduction="batchmean"),
                  [np.log(SOFT), SOFT[::-1].copy()]),
    "SmoothL1Loss": (dict(delta=0.7), [_f(3, 4), _f(3, 4)]),
    "MarginRankingLoss": (dict(margin=0.2), [_f(4), _f(4), PM1]),
    "CosineEmbeddingLoss": ({}, [_f(4, 6), _f(4, 6), PM1]),
    "HingeEmbeddingLoss": ({}, [_f(4, 6), BIN * 2 - 1]),
    "TripletMarginLoss": (dict(swap=True), [_f(4, 6), _f(4, 6), _f(4, 6)]),
    "SigmoidFocalLoss": (dict(gamma=1.0), [_f(4, 6), BIN]),
    "SoftMarginLoss": ({}, [_f(4, 6), BIN * 2 - 1]),
    "MultiLabelSoftMarginLoss": ({}, [_f(4, 6), BIN]),
    "MultiMarginLoss": (dict(margin=0.5), [_f(4, 5),
                                          np.array([0, 2, 4, 1])]),
    "GaussianNLLLoss": (dict(full=True), [_f(4, 3), _f(4, 3),
                                          _f(4, 3, lo=0.1, hi=2.0)]),
    "PoissonNLLLoss": ({}, [_f(4, 3), _f(4, 3, lo=0.0, hi=4.0)]),
    "PairwiseDistance": (dict(p=3.0, keepdim=True), [_f(4, 6), _f(4, 6)]),
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_loss_layer_matches_reference(layer):
    kw, arrays = LAYERS[layer]
    ref, port = _both(arrays)
    want = getattr(ref_nn, layer)(**kw)(*ref)
    got = getattr(port_nn, layer)(**kw)(*port)
    assert isinstance(getattr(port_nn, layer)(**kw), torch.nn.Module)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_ctc_and_hsigmoid_layers_match_reference():
    t, b, c = 10, 2, 5
    lp = torch.log_softmax(torch.from_numpy(_f(t, b, c, seed=3)),
                           -1).numpy()
    arrays = [lp, np.array([[1, 2, 3], [2, 2, 0]], np.int32),
              np.array([10, 8], np.int32), np.array([3, 2], np.int32)]
    ref, port = _both(arrays)
    want = ref_nn.CTCLoss(blank=0)(*ref)
    got = port_nn.CTCLoss(blank=0)(*port)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    paddle.seed(0)
    ref_h = ref_nn.HSigmoidLoss(4, 6)
    port_h = port_nn.HSigmoidLoss(4, 6)
    assert tuple(port_h.weight.shape) == (5, 4) and not port_h.bias.any()
    with torch.no_grad():
        port_h.weight.copy_(torch.from_numpy(_np(ref_h.weight).copy()))
        port_h.bias.copy_(torch.from_numpy(_np(ref_h.bias).copy()))
    x, lab = _f(3, 4), np.array([0, 5, 2])
    r, p = _both([x, lab])
    np.testing.assert_allclose(_np(port_h(*p)), _np(ref_h(*r)), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="num_classes"):
        port_nn.HSigmoidLoss(4, 1)


@pytest.mark.parametrize("variant", ["no_weight", "bias", "weight_bias",
                                     "axis1"])
def test_rms_norm_variants_match_reference(variant):
    """F.rms_norm without a weight, or with a bias: the reference's XLA
    formula (its Pallas kernel takes neither), on both packages."""
    x, w, b = _f(3, 4, 8), _f(8, lo=0.5, hi=1.5), _f(8)
    kw = {"no_weight": dict(weight=None),
          "bias": dict(weight=None, bias=b),
          "weight_bias": dict(weight=w, bias=b),
          "axis1": dict(weight=_f(4, 8, lo=0.5, hi=1.5), begin_norm_axis=1),
          }[variant]
    ref_kw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
    port_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
    want = RF.rms_norm(paddle.to_tensor(x), epsilon=1e-5, **ref_kw)
    got = PF.rms_norm(torch.from_numpy(x), epsilon=1e-5, **port_kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_losses_cast_under_amp_as_reference():
    """A black-listed loss reads f32 under amp; its port says so too."""
    import paddle_tpu.amp as ref_amp
    import paddle_tpu_torch.amp as port_amp

    a, b = _f(3, 4), _f(3, 4)
    ref, port = _both([a, b])
    with ref_amp.auto_cast(level="O2", dtype="bfloat16"):
        want = RF.mse_loss(ref[0].astype("bfloat16"),
                           ref[1].astype("bfloat16"))
        want_m = RF.margin_ranking_loss(ref[0][:, 0], ref[1][:, 0],
                                        paddle.to_tensor(PM1[:3]))
    with port_amp.auto_cast(level="O2", dtype="bfloat16"):
        got = PF.mse_loss(port[0].bfloat16(), port[1].bfloat16())
        got_m = PF.margin_ranking_loss(port[0][:, 0], port[1][:, 0],
                                       torch.from_numpy(PM1[:3]))
    assert got.dtype == torch.float32 and "float32" in str(want.dtype)
    assert got_m.dtype == torch.bfloat16 and "bfloat16" in str(want_m.dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)
