"""The manifest tier's functionals and layers held against paddle_tpu's on
the CPU: ``one_hot``, the dropouts, ``cosine_similarity``,
``label_smooth``, ``bilinear``, ``fold`` / ``unfold``,
``class_center_sample``, ``temporal_shift``, ``affine_grid`` /
``grid_sample`` (every mode, padding mode and ``align_corners``),
``pairwise_distance``, ``sequence_mask``, ``gather_tree``,
``flash_attention.flash_attn_qkvpacked`` and the layers over them. Both
packages get the same ``np.random.RandomState`` arrays; a layer's
parameters are carried across by value.

Tolerances, each with its reason:
- f32 values and gradients: ``1e-5`` absolute and relative (the same
  products and sums in other orders: XLA against PyTorch);
- ``flash_attn_qkvpacked``: ``1e-5`` forward, ``1e-4`` gradients (the
  backward recomputes P from the log-sum-exp in another order);
- integer and mask outputs: equal values.
The dropouts and ``class_center_sample`` draw torch's random numbers,
not the reference's JAX keys (ROADMAP queue C's deliberate difference),
so they are held by reproducibility at a seed, by their structure and by
their moments (within 5 sigma), and equal the reference where no draw is
made (eval mode, p = 0, every positive kept).
"""
import importlib
import math

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as RF
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = _place._current
    import paddle_tpu_torch as T

    T.set_device("cpu")
    yield
    _place._current = saved


def _rand(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _ref_run(fn, arrays, weight, grad=True):
    """The reference's output and the gradients of sum(out * weight)."""
    ts = [P.to_tensor(a, stop_gradient=not grad) for a in arrays]
    out = fn(*ts)
    if grad:
        (out * P.to_tensor(weight)).sum().backward()
    return (np.asarray(out.numpy()),
            [np.asarray(t.grad.numpy()) for t in ts] if grad else [])


def _port_run(fn, arrays, weight, grad=True):
    ts = [torch.tensor(a, requires_grad=grad) for a in arrays]
    out = fn(*ts)
    if grad:
        (out * torch.from_numpy(weight)).sum().backward()
    # an input the output does not depend on smoothly (nearest's grid)
    # gets no gradient: zeros, as the reference's
    return (out.detach().numpy(),
            [np.zeros_like(a) if t.grad is None else t.grad.numpy()
             for a, t in zip(arrays, ts)] if grad else [])


def _hold(ref_fn, port_fn, arrays, seed=0, grad=True, tol=TOL,
          grad_tol=TOL):
    with torch.no_grad():
        shape = port_fn(*[torch.from_numpy(a) for a in arrays]).shape
    weight = np.random.RandomState(seed + 100).randn(*shape).astype(
        np.float32)
    want, want_g = _ref_run(ref_fn, arrays, weight, grad)
    got, got_g = _port_run(port_fn, arrays, weight, grad)
    np.testing.assert_allclose(got, want, **tol)
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, w, err_msg=f"grad {i}", **grad_tol)


# --------------------------------------------------- differentiable cases
def _cases():
    rng = np.random.RandomState(0)
    fold_pads = [1, 2, 0, 1]  # top, left, bottom, right
    oh, ow, k, st = 7, 6, 3, 2
    lh = (oh + 1 + 0 - k) // st + 1
    lw = (ow + 2 + 1 - k) // st + 1
    return {
        "cosine_similarity": (
            lambda m: lambda a, b: m.cosine_similarity(a, b, axis=1),
            [_rand(rng, 4, 6, 3), _rand(rng, 4, 6, 3)]),
        "cosine_similarity_eps": (
            lambda m: lambda a, b: m.cosine_similarity(a, b, axis=-1,
                                                       eps=0.5),
            [0.1 * _rand(rng, 3, 5), 0.1 * _rand(rng, 3, 5)]),
        "label_smooth": (
            lambda m: lambda y: m.label_smooth(y, epsilon=0.2),
            [np.eye(5, dtype=np.float32)[rng.randint(0, 5, 6)]]),
        "label_smooth_prior": (
            lambda m: lambda y, p: m.label_smooth(y, p, epsilon=0.3),
            [np.eye(5, dtype=np.float32)[rng.randint(0, 5, 6)],
             _rand(rng, 1, 5, lo=0.0, hi=0.4)]),
        "bilinear": (
            lambda m: lambda a, b, w, bias: m.bilinear(a, b, w, bias),
            [_rand(rng, 4, 3), _rand(rng, 4, 5), _rand(rng, 6, 3, 5),
             _rand(rng, 6)]),
        "unfold": (
            lambda m: lambda x: m.unfold(x, [2, 3], strides=2,
                                         paddings=[1, 0, 1, 2],
                                         dilations=1),
            [_rand(rng, 2, 3, 6, 7)]),
        "unfold_dilated": (
            lambda m: lambda x: m.unfold(x, 2, strides=1, paddings=1,
                                         dilations=2),
            [_rand(rng, 1, 2, 5, 5)]),
        "fold": (
            lambda m: lambda x: m.fold(x, [5, 6], 2),
            [_rand(rng, 2, 3 * 4, 4 * 5)]),
        "fold_strided_padded": (
            lambda m: lambda x: m.fold(x, [oh, ow], k, strides=st,
                                       paddings=fold_pads),
            [_rand(rng, 2, 2 * k * k, lh * lw)]),
        "temporal_shift": (
            lambda m: lambda x: m.temporal_shift(x, 3, 0.25),
            [_rand(rng, 6, 8, 2, 3)]),
        "affine_grid": (
            lambda m: lambda th: m.affine_grid(th, [2, 3, 5, 7]),
            [_rand(rng, 2, 2, 3)]),
        "affine_grid_unaligned": (
            lambda m: lambda th: m.affine_grid(th, [2, 3, 4, 6],
                                               align_corners=False),
            [_rand(rng, 2, 2, 3)]),
        "pairwise_distance": (
            lambda m: lambda a, b: m.pairwise_distance(a, b),
            [_rand(rng, 5, 4), _rand(rng, 5, 4)]),
        "pairwise_distance_p1_keepdim": (
            lambda m: lambda a, b: m.pairwise_distance(a, b, p=1.0,
                                                       keepdim=True),
            [_rand(rng, 5, 4), _rand(rng, 5, 4)]),
        "pairwise_distance_inf": (
            lambda m: lambda a, b: m.pairwise_distance(a, b, p=math.inf),
            [_rand(rng, 5, 4), _rand(rng, 5, 4)]),
        "one_hot": (
            lambda m: lambda x: m.one_hot(x, 6),
            [rng.randint(0, 6, (3, 4)).astype(np.int64)]),
        "sequence_mask": (
            lambda m: lambda x: m.sequence_mask(x),
            [rng.randint(0, 6, (3, 4)).astype(np.int64)]),
        "sequence_mask_maxlen_f32": (
            lambda m: lambda x: m.sequence_mask(x, maxlen=7,
                                                dtype="float32"),
            [rng.randint(0, 6, (5,)).astype(np.int64)]),
        "gather_tree": (
            lambda m: lambda i, p: m.gather_tree(i, p),
            [rng.randint(0, 50, (5, 3, 4)).astype(np.int64),
             rng.randint(0, 4, (5, 3, 4)).astype(np.int64)]),
    }


_INT_CASES = ("one_hot", "sequence_mask", "sequence_mask_maxlen_f32",
              "gather_tree")


@pytest.mark.parametrize("name", sorted(_cases()))
def test_functional_matches_reference(name):
    make, arrays = _cases()[name]
    if name in _INT_CASES:
        want = make(RF)(*[P.to_tensor(a) for a in arrays]).numpy()
        got = make(F)(*[torch.from_numpy(a) for a in arrays])
        # values equal (the reference, without JAX's x64, narrows int64
        # to int32)
        np.testing.assert_array_equal(got.numpy(), want)
        return
    _hold(make(RF), make(F), arrays)


GRID_MODES = [(m, p, a) for m in ("bilinear", "nearest")
              for p in ("zeros", "border", "reflection")
              for a in (True, False)]


@pytest.mark.parametrize("mode,padding_mode,align", GRID_MODES,
                         ids=[f"{m}-{p}-{int(a)}" for m, p, a in GRID_MODES])
def test_grid_sample_matches_reference(mode, padding_mode, align):
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 3, 5, 6)
    grid = _rand(rng, 2, 4, 5, 2, lo=-1.4, hi=1.4)

    def make(m):
        return lambda a, g: m.grid_sample(a, g, mode=mode,
                                          padding_mode=padding_mode,
                                          align_corners=align)

    _hold(make(RF), make(F), [x, grid])


def test_grid_sample_of_affine_grid_is_the_identity():
    x = torch.randn(2, 3, 5, 7, generator=torch.Generator().manual_seed(0))
    theta = torch.tensor([[1.0, 0, 0], [0, 1, 0]]).expand(2, 2, 3)
    out = F.grid_sample(x, F.affine_grid(theta, [2, 3, 5, 7]))
    torch.testing.assert_close(out, x, rtol=1e-5, atol=1e-5)


def _ref_qkvpacked():
    """The reference's submodule function; importing the submodule binds
    the package's ``flash_attention`` name to it, so the function is put
    back for the reference tests that call it."""
    saved = RF.flash_attention
    mod = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
    RF.flash_attention = saved
    return mod.flash_attn_qkvpacked


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_qkvpacked_matches_reference(causal):
    ref = _ref_qkvpacked()
    port = importlib.import_module(
        "paddle_tpu_torch.nn.functional.flash_attention")
    assert F.flash_attention is port.flash_attention
    qkv = _rand(np.random.RandomState(4), 2, 8, 3, 2, 64)
    _hold(lambda t: ref(t, causal=causal)[0],
          lambda t: port.flash_attn_qkvpacked(t, causal=causal)[0], [qkv],
          grad_tol=dict(rtol=1e-4, atol=1e-4))


# ---------------------------------------------------------------- random
def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("fn,shape,fmt", [
    ("dropout2d", (16, 32, 3, 3), "NCHW"),
    ("dropout2d", (16, 3, 3, 32), "NHWC"),
    ("dropout3d", (8, 32, 2, 2, 2), "NCDHW"),
    ("dropout3d", (8, 2, 2, 2, 32), "NDHWC")])
def test_channel_dropouts_drop_whole_channels(fn, shape, fmt):
    x = torch.rand(shape, generator=_gen(0)) + 0.5
    p = 0.4
    f = getattr(F, fn)
    out = f(x, p, data_format=fmt, generator=_gen(1))
    torch.testing.assert_close(f(x, p, data_format=fmt, generator=_gen(1)),
                               out, rtol=0, atol=0)
    ch = 1 if fmt.startswith("NC") else x.dim() - 1
    spatial = [d for d in range(x.dim()) if d not in (0, ch)]
    kept = (out != 0).float().amax(dim=spatial)
    dropped = (out == 0).float().amin(dim=spatial)
    assert bool(((kept == 1) ^ (dropped == 1)).all()), "a channel split"
    torch.testing.assert_close(out[out != 0], (x / (1 - p))[out != 0])
    n = kept.numel()
    assert abs(kept.mean().item() - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n)
    for training in (False,):
        ref = getattr(RF, fn)(P.to_tensor(x.numpy()), p, training=training,
                              data_format=fmt).numpy()
        np.testing.assert_array_equal(
            f(x, p, training=training, data_format=fmt).numpy(), ref)


def test_alpha_dropout_keeps_moments_and_structure():
    x = torch.randn(200_000, generator=_gen(0))
    p = 0.3
    out = F.alpha_dropout(x, p, generator=_gen(2))
    torch.testing.assert_close(F.alpha_dropout(x, p, generator=_gen(2)),
                               out, rtol=0, atol=0)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2))) ** 0.5
    b = -a * alpha_p * p
    dropped = (out - (a * alpha_p + b)).abs() < 1e-6
    torch.testing.assert_close(out[~dropped], a * x[~dropped] + b)
    n = x.numel()
    assert abs(dropped.float().mean().item() - p) <= 5 * math.sqrt(
        p * (1 - p) / n)
    # the point of alpha dropout: unit-normal input keeps mean 0, var 1
    assert abs(out.mean().item()) <= 5 / math.sqrt(n) * 1.5
    assert abs(out.var().item() - 1.0) <= 0.02
    ref_eval = RF.alpha_dropout(P.to_tensor(x[:64].numpy()), p,
                                training=False).numpy()
    np.testing.assert_array_equal(
        F.alpha_dropout(x[:64], p, training=False).numpy(), ref_eval)


def test_class_center_sample_keeps_positives_and_draws_uniformly():
    lab = np.asarray([3, 7, 3, 1], np.int64)
    # every positive kept: no draw, equal to the reference
    r_ref, s_ref = RF.class_center_sample(P.to_tensor(np.arange(10)), 20, 4)
    r, s = F.class_center_sample(torch.arange(10), 20, 4)
    np.testing.assert_array_equal(s.numpy(), s_ref.numpy())
    np.testing.assert_array_equal(r.numpy(), r_ref.numpy())
    # with draws: the positives first (ascending, as the reference's),
    # labels remapped onto them, negatives distinct and uniform
    r_ref, s_ref = RF.class_center_sample(P.to_tensor(lab), 20, 8)
    counts = np.zeros(20)
    for seed in range(200):
        r, s = F.class_center_sample(torch.from_numpy(lab), 20, 8,
                                     generator=_gen(seed))
        s = s.numpy()
        assert s.shape == (8,) and len(set(s.tolist())) == 8
        np.testing.assert_array_equal(s[:3], s_ref.numpy()[:3])
        np.testing.assert_array_equal(r.numpy(), r_ref.numpy())
        assert (s[r.numpy()] == lab).all()
        counts[s[3:]] += 1
    r2, s2 = F.class_center_sample(torch.from_numpy(lab), 20, 8,
                                   generator=_gen(5))
    _, s3 = F.class_center_sample(torch.from_numpy(lab), 20, 8,
                                  generator=_gen(5))
    np.testing.assert_array_equal(s2.numpy(), s3.numpy())
    neg = np.setdiff1d(np.arange(20), lab)
    q = 5 / 17  # each of the 17 negatives: 5 drawn of 17
    sigma = math.sqrt(200 * q * (1 - q))
    assert np.abs(counts[neg] - 200 * q).max() <= 5 * sigma
    assert counts[np.unique(lab)].sum() == 0
    with pytest.raises(NotImplementedError, match="group"):
        F.class_center_sample(torch.from_numpy(lab), 20, 8, group=object())


# ----------------------------------------------------------------- layers
def _carry(ref_layer, port_layer):
    with torch.no_grad():
        for name, p in port_layer.named_parameters():
            p.copy_(torch.from_numpy(np.array(
                ref_layer.state_dict()[name].numpy())))


def _layer_cases():
    rng = np.random.RandomState(5)
    return {
        "ChannelShuffle": (lambda m: m.ChannelShuffle(3),
                           [_rand(rng, 2, 6, 3, 3)]),
        "CosineSimilarity": (lambda m: m.CosineSimilarity(axis=2),
                             [_rand(rng, 2, 3, 4), _rand(rng, 2, 3, 4)]),
        "Bilinear": (lambda m: m.Bilinear(3, 4, 5),
                     [_rand(rng, 6, 3), _rand(rng, 6, 4)]),
        "Unfold": (lambda m: m.Unfold([2, 2], strides=2),
                   [_rand(rng, 2, 3, 6, 6)]),
        "Fold": (lambda m: m.Fold([4, 4], 2, strides=2),
                 [_rand(rng, 2, 12, 4)]),
        "Dropout2D_eval": (lambda m: m.Dropout2D(0.5).eval(),
                           [_rand(rng, 2, 3, 4, 4)]),
        "Dropout3D_eval": (lambda m: m.Dropout3D(0.5).eval(),
                           [_rand(rng, 2, 3, 2, 2, 2)]),
        "AlphaDropout_eval": (lambda m: m.AlphaDropout(0.5).eval(),
                              [_rand(rng, 4, 5)]),
    }


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layer_matches_reference(name):
    make, arrays = _layer_cases()[name]
    P.seed(1)
    ref = make(P.nn)
    port = make(nn)
    _carry(ref, port)
    _hold(ref, port, arrays)


def test_dropout_layers_train_through_their_functionals():
    x = torch.ones(8, 16, 4, 4)
    torch.manual_seed(3)
    out = nn.Dropout2D(0.5)(x)
    torch.manual_seed(3)
    torch.testing.assert_close(out, F.dropout2d(x, 0.5), rtol=0, atol=0)
    torch.manual_seed(4)
    out = nn.AlphaDropout(0.5)(x)
    torch.manual_seed(4)
    torch.testing.assert_close(out, F.alpha_dropout(x, 0.5), rtol=0, atol=0)
