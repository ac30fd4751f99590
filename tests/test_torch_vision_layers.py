"""The port's vision-tier functionals and layers held against paddle_tpu's
on the CPU: convolutions and their transposes, pooling, batch, group,
instance and local-response norms, resampling, padding and the newly
ported activations. Inputs come from ``np.random.RandomState``; both
packages get the same arrays.

Tolerances, each with its reason:
- f32: ``1e-5`` absolute and relative (the same products and sums in
  other orders: XLA's convolution and reduce_window against PyTorch's);
- bf16 (GroupNorm, BatchNorm's formula path): two bf16 rounding steps of
  the result (``2^-6`` relative) plus ``2^-6`` absolute. Both packages
  round the same intermediates to bf16, op for op; XLA on the CPU may
  keep an elementwise chain in f32 between its roundings (excess
  precision), which moves a result by one step, and a step of the
  pre-affine value is a step of the result times the weight;
- integer outputs (pooling indices) and running-statistic updates in f32:
  indices equal, statistics ``1e-6``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as RN
import paddle_tpu.nn.functional as RF
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _ref(t):
    return np.asarray(t._value, np.float32)


def _port(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------ convolution
CONV_CASES = {
    # name: (fn, x shape, w shape, bias, kwargs)
    "same_stride2": ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), True,
                     dict(stride=2, padding="SAME")),
    "same_stride2_even": ("conv2d", (2, 3, 8, 8), (4, 3, 4, 4), True,
                          dict(stride=2, padding="SAME")),
    "valid_stride2": ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), False,
                      dict(stride=2, padding="VALID")),
    "asymmetric_pads": ("conv2d", (2, 3, 7, 6), (5, 3, 3, 2), True,
                        dict(padding=[1, 2, 0, 1])),
    "full_rank_pads": ("conv1d", (1, 2, 6), (3, 2, 3), True,
                       dict(padding=[[0, 0], [0, 0], [2, 1]])),
    "nhwc": ("conv2d", (2, 7, 7, 3), (4, 3, 3, 3), True,
             dict(padding=1, data_format="NHWC")),
    "depthwise": ("conv2d", (2, 6, 8, 8), (6, 1, 3, 3), True,
                  dict(padding=1, groups=6, stride=2)),
    "groups2": ("conv2d", (1, 4, 6, 6), (6, 2, 3, 3), False,
                dict(padding=1, groups=2)),
    "dilation2": ("conv2d", (2, 3, 10, 10), (4, 3, 3, 3), True,
                  dict(padding=2, dilation=2)),
    "dilation2_same": ("conv2d", (1, 3, 9, 9), (4, 3, 3, 3), False,
                       dict(padding="SAME", dilation=2, stride=2)),
    "conv1d": ("conv1d", (2, 3, 11), (4, 3, 3), True,
               dict(padding=1, stride=2)),
    "conv1d_nlc": ("conv1d", (2, 11, 3), (4, 3, 3), True,
                   dict(padding="SAME", data_format="NLC")),
    "conv3d": ("conv3d", (1, 2, 5, 6, 5), (3, 2, 3, 3, 3), True,
               dict(padding=1)),
    # transposes: weight (in, out/groups, *k)
    "t_stride2_opad": ("conv2d_transpose", (2, 4, 5, 5), (4, 3, 3, 3), True,
                       dict(stride=2, padding=1, output_padding=1)),
    "t_asymmetric": ("conv2d_transpose", (1, 3, 4, 5), (3, 2, 3, 3), True,
                     dict(stride=2, padding=[0, 1, 2, 0])),
    "t_groups2": ("conv2d_transpose", (1, 4, 5, 5), (4, 3, 3, 3), True,
                  dict(stride=2, padding=1, groups=2)),
    "t_dilation2": ("conv2d_transpose", (1, 3, 5, 5), (3, 2, 3, 3), False,
                    dict(dilation=2, padding=1)),
    "t_nhwc": ("conv2d_transpose", (2, 5, 5, 3), (3, 4, 4, 4), True,
               dict(stride=2, padding=1, data_format="NHWC")),
    "t_same_stride1": ("conv2d_transpose", (1, 3, 6, 6), (3, 2, 3, 3), True,
                       dict(padding="SAME")),
    "t_conv1d": ("conv1d_transpose", (2, 3, 7), (3, 2, 4), True,
                 dict(stride=3, padding=1)),
    "t_conv3d": ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 2, 3, 3, 3), True,
                 dict(stride=2, padding=1, output_padding=1)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_reference(case):
    fn, xs, ws, with_bias, kw = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    x, w = _rand(rng, *xs), _rand(rng, *ws)
    out_ch = ws[1] * kw.get("groups", 1) if fn.endswith("transpose") \
        else ws[0]
    b = _rand(rng, out_ch) if with_bias else None
    want = _ref(getattr(RF, fn)(
        paddle.to_tensor(x), paddle.to_tensor(w),
        None if b is None else paddle.to_tensor(b), **kw))
    got = _port(getattr(F, fn)(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_transposed_string_padding_at_stride_2_raises_as_reference():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 2, 3, 3)
    with pytest.raises(ValueError, match="String padding"):
        F.conv2d_transpose(x, w, stride=2, padding="SAME")


def test_conv_layers_carry_weights_untransposed():
    rng = np.random.RandomState(3)
    x = _rand(rng, 2, 3, 8, 8)
    for ref_cls, port_cls, kw in (
            (RN.Conv2D, nn.Conv2D, dict(stride=2, padding=1)),
            (RN.Conv2DTranspose, nn.Conv2DTranspose,
             dict(stride=2, padding=1, output_padding=1))):
        paddle.seed(0)
        ref = ref_cls(3, 4, 3, **kw)
        port = port_cls(3, 4, 3, **kw)
        assert port.weight.shape == tuple(ref.weight.shape)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(_ref(ref.weight)))
            port.bias.copy_(torch.from_numpy(_ref(ref.bias)))
        np.testing.assert_allclose(
            _port(port(torch.from_numpy(x))),
            _ref(ref(paddle.to_tensor(x))), **TOL)


def test_conv_default_init_bounds():
    conv = nn.Conv2D(6, 8, 3, groups=2)
    k = 1.0 / np.sqrt(3 * 9)
    for p in (conv.weight, conv.bias):
        top = float(p.detach().abs().max())
        assert k / 2 < top <= k
    assert nn.Conv2D(3, 4, 1, bias_attr=False).bias is None


# ---------------------------------------------------------------- pooling
POOL_CASES = {
    "max_k3s2p1": ("max_pool2d", (2, 3, 9, 9), (3, 2, 1), {}),
    "max_ceil": ("max_pool2d", (1, 2, 7, 8), (2, 2, 0), dict(ceil_mode=True)),
    "max_ceil_pad": ("max_pool2d", (1, 2, 7, 7), (3, 2, 1),
                     dict(ceil_mode=True)),
    "max_same": ("max_pool2d", (1, 2, 7, 7), (3, 2, "SAME"), {}),
    "max_nhwc": ("max_pool2d", (2, 6, 6, 3), (2, 2, 0),
                 dict(data_format="NHWC")),
    "avg_exclusive_pad": ("avg_pool2d", (2, 3, 7, 7), (3, 2, 1), {}),
    "avg_inclusive_pad": ("avg_pool2d", (2, 3, 7, 7), (3, 2, 1),
                          dict(exclusive=False)),
    "avg_exclusive_ceil": ("avg_pool2d", (1, 2, 7, 8), (3, 2, 1),
                           dict(ceil_mode=True)),
    "avg_inclusive_ceil": ("avg_pool2d", (1, 2, 7, 8), (3, 2, 1),
                           dict(ceil_mode=True, exclusive=False)),
    "avg_asym_pads": ("avg_pool2d", (1, 2, 6, 6), (2, 2, [1, 0, 0, 1]), {}),
    "max_1d": ("max_pool1d", (2, 3, 11), (3, 2, 1), dict(ceil_mode=True)),
    "avg_1d": ("avg_pool1d", (2, 3, 11), (3, 2, 1), {}),
    "max_3d": ("max_pool3d", (1, 2, 5, 6, 5), (2, 2, 0), {}),
    "avg_3d": ("avg_pool3d", (1, 2, 5, 6, 5), (3, 2, 1), {}),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_reference(case):
    fn, xs, (k, s, p), kw = POOL_CASES[case]
    x = _rand(np.random.RandomState(len(case)), *xs)
    want = _ref(getattr(RF, fn)(paddle.to_tensor(x), k, s, p, **kw))
    got = _port(getattr(F, fn)(torch.from_numpy(x), k, s, p, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fn,size,xs", [
    ("adaptive_avg_pool2d", (1, 1), (2, 3, 7, 7)),
    ("adaptive_avg_pool2d", (3, 3), (2, 3, 7, 7)),
    ("adaptive_avg_pool2d", (7, 5), (1, 2, 10, 11)),
    ("adaptive_max_pool2d", (3, 4), (1, 2, 10, 11)),
    ("adaptive_avg_pool1d", 4, (2, 3, 10)),
    ("adaptive_max_pool1d", 3, (2, 3, 10)),
    ("adaptive_avg_pool3d", (2, 3, 2), (1, 2, 5, 7, 4)),
])
def test_adaptive_pool_matches_reference(fn, size, xs):
    x = _rand(np.random.RandomState(5), *xs)
    want = _ref(getattr(RF, fn)(paddle.to_tensor(x), size))
    got = _port(getattr(F, fn)(torch.from_numpy(x), size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_max_pool_mask_and_unpool_match_reference():
    x = _rand(np.random.RandomState(6), 2, 3, 8, 8)
    ref_out, ref_idx = RF.max_pool2d(paddle.to_tensor(x), 2, 2,
                                     return_mask=True)
    out, idx = F.max_pool2d(torch.from_numpy(x), 2, 2, return_mask=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx._value))
    np.testing.assert_allclose(_port(out), _ref(ref_out), **TOL)
    want = _ref(RF.max_unpool2d(ref_out, ref_idx, 2, 2))
    np.testing.assert_allclose(_port(F.max_unpool2d(out, idx, 2, 2)), want,
                               **TOL)


def test_pool_layers():
    x = _rand(np.random.RandomState(7), 2, 3, 9, 9)
    for ref_layer, port_layer in (
            (RN.MaxPool2D(3, 2, 1, ceil_mode=True),
             nn.MaxPool2D(3, 2, 1, ceil_mode=True)),
            (RN.AvgPool2D(3, 2, 1, exclusive=False),
             nn.AvgPool2D(3, 2, 1, exclusive=False)),
            (RN.AdaptiveAvgPool2D((2, 3)), nn.AdaptiveAvgPool2D((2, 3)))):
        np.testing.assert_allclose(_port(port_layer(torch.from_numpy(x))),
                                   _ref(ref_layer(paddle.to_tensor(x))),
                                   **TOL)


# ------------------------------------------------------------------ norms
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_train_then_eval_matches_reference(data_format):
    """Two training steps at momentum 0.9 (the running statistics move by
    paddle's rule, the variance unbiased), then an eval forward."""
    rng = np.random.RandomState(8)
    c = 4
    xs = [_rand(rng, 3, c, 5, 5) * 2 + 1 for _ in range(3)]
    if data_format == "NHWC":
        xs = [x.transpose(0, 2, 3, 1).copy() for x in xs]
    w, b = _rand(rng, c), _rand(rng, c)
    rm_r = paddle.to_tensor(np.zeros(c, np.float32))
    rv_r = paddle.to_tensor(np.ones(c, np.float32))
    rm, rv = torch.zeros(c), torch.ones(c)
    for step, x in enumerate(xs):
        training = step < 2
        want = _ref(RF.batch_norm(
            paddle.to_tensor(x), rm_r, rv_r, paddle.to_tensor(w),
            paddle.to_tensor(b), training=training, momentum=0.9,
            data_format=data_format))
        got = _port(F.batch_norm(
            torch.from_numpy(x), rm, rv, torch.from_numpy(w),
            torch.from_numpy(b), training=training, momentum=0.9,
            data_format=data_format))
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(rm.numpy(), _ref(rm_r), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(rv.numpy(), _ref(rv_r), rtol=1e-6,
                                   atol=1e-6)
    # paddle's rule by hand on the first step's batch
    x0 = xs[0] if data_format == "NCHW" else xs[0].transpose(0, 3, 1, 2)
    n = x0.size // c
    mean1 = x0.mean(axis=(0, 2, 3))
    var1 = x0.var(axis=(0, 2, 3)) * n / (n - 1)
    rm2, rv2 = torch.zeros(c), torch.ones(c)
    F.batch_norm(torch.from_numpy(xs[0]), rm2, rv2, training=True,
                 data_format=data_format)
    np.testing.assert_allclose(rm2.numpy(), 0.1 * mean1, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rv2.numpy(), 0.9 + 0.1 * var1, rtol=1e-5)


def test_batch_norm_bf16_rounds_before_the_affine():
    rng = np.random.RandomState(9)
    x = (_rand(rng, 4, 3, 6, 6) * 3).astype(np.float32)
    w, b = _rand(rng, 3), _rand(rng, 3)
    xb = paddle.to_tensor(x).astype("bfloat16")
    for training in (True, False):
        rm_r = paddle.to_tensor(np.full(3, 0.5, np.float32))
        rv_r = paddle.to_tensor(np.full(3, 2.0, np.float32))
        rm, rv = torch.full((3,), 0.5), torch.full((3,), 2.0)
        want = _ref(RF.batch_norm(xb, rm_r, rv_r, paddle.to_tensor(w),
                                  paddle.to_tensor(b), training=training))
        got = F.batch_norm(torch.from_numpy(x).bfloat16(), rm, rv,
                           torch.from_numpy(w), torch.from_numpy(b),
                           training=training)
        np.testing.assert_allclose(_port(got), want, **BF16_TOL)
        np.testing.assert_allclose(rm.numpy(), _ref(rm_r), rtol=1e-6)


def test_batch_norm_layer_buffers_and_sync_refusal():
    bn = nn.BatchNorm2D(4)
    assert dict(bn.named_buffers()).keys() == {"_mean", "_variance"}
    assert bn._mean.dtype == torch.float32
    bn(torch.randn(2, 4, 3, 3))
    assert float(bn._mean.abs().sum()) > 0
    with pytest.raises(NotImplementedError, match="A7"):
        nn.SyncBatchNorm(4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_group_norm_matches_reference(dtype, data_format):
    rng = np.random.RandomState(10)
    x = _rand(rng, 2, 8, 5, 5) * 2 + 0.5
    if data_format == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w, b = _rand(rng, 8), _rand(rng, 8)
    xr, wr, br = (paddle.to_tensor(a) for a in (x, w, b))
    xp, wp, bp = (torch.from_numpy(a) for a in (x, w, b))
    if dtype == "bfloat16":
        xr, wr, br = (t.astype("bfloat16") for t in (xr, wr, br))
        xp, wp, bp = (t.bfloat16() for t in (xp, wp, bp))
    want = _ref(RF.group_norm(xr, 4, 1e-5, wr, br, data_format))
    got = F.group_norm(xp, 4, 1e-5, wp, bp, data_format)
    assert got.dtype == xp.dtype
    np.testing.assert_allclose(_port(got), want,
                               **(TOL if dtype == "float32" else BF16_TOL))


def test_group_and_instance_norm_layers():
    rng = np.random.RandomState(11)
    x = _rand(rng, 2, 6, 4, 4)
    for ref_layer, port_layer in ((RN.GroupNorm(3, 6), nn.GroupNorm(3, 6)),
                                  (RN.InstanceNorm2D(6),
                                   nn.InstanceNorm2D(6)),
                                  (RN.LocalResponseNorm(3),
                                   nn.LocalResponseNorm(3))):
        np.testing.assert_allclose(_port(port_layer(torch.from_numpy(x))),
                                   _ref(ref_layer(paddle.to_tensor(x))),
                                   **TOL)


def test_instance_lrn_normalize_functionals():
    rng = np.random.RandomState(12)
    x = _rand(rng, 2, 5, 4, 3)
    w, b = _rand(rng, 5), _rand(rng, 5)
    np.testing.assert_allclose(
        _port(F.instance_norm(torch.from_numpy(x),
                              weight=torch.from_numpy(w),
                              bias=torch.from_numpy(b))),
        _ref(RF.instance_norm(paddle.to_tensor(x),
                              weight=paddle.to_tensor(w),
                              bias=paddle.to_tensor(b))), **TOL)
    np.testing.assert_allclose(
        _port(F.local_response_norm(torch.from_numpy(x), 4)),
        _ref(RF.local_response_norm(paddle.to_tensor(x), 4)), **TOL)
    np.testing.assert_allclose(
        _port(F.normalize(torch.from_numpy(x), p=2, axis=1)),
        _ref(RF.normalize(paddle.to_tensor(x), p=2, axis=1)), **TOL)


# ------------------------------------------------------------- resampling
INTERP_CASES = {
    "nearest_up2": ((1, 2, 4, 5), dict(scale_factor=2, mode="nearest")),
    "nearest_odd": ((1, 2, 5, 7), dict(size=(8, 3), mode="nearest")),
    "bilinear_up": ((1, 2, 4, 5), dict(size=(9, 7), mode="bilinear")),
    "bilinear_down": ((1, 2, 9, 8), dict(size=(4, 3), mode="bilinear")),
    "bilinear_align": ((1, 2, 4, 5), dict(size=(7, 9), mode="bilinear",
                                          align_corners=True)),
    "bicubic_up": ((1, 2, 5, 4), dict(size=(8, 9), mode="bicubic")),
    "nearest_nhwc": ((2, 4, 3, 2), dict(scale_factor=2, mode="nearest",
                                        data_format="NHWC")),
    "linear_1d": ((2, 3, 5), dict(size=8, mode="linear",
                                  data_format="NCW")),
}


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolate_matches_reference(case):
    xs, kw = INTERP_CASES[case]
    x = _rand(np.random.RandomState(len(case)), *xs)
    want = _ref(RF.interpolate(paddle.to_tensor(x), **kw))
    got = _port(F.interpolate(torch.from_numpy(x), **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_resampling_and_layout_layers():
    x = _rand(np.random.RandomState(13), 2, 8, 4, 4)
    pairs = [
        (RN.Upsample(scale_factor=2), nn.Upsample(scale_factor=2)),
        (RN.UpsamplingNearest2D(size=(6, 5)),
         nn.UpsamplingNearest2D(size=(6, 5))),
        (RN.UpsamplingBilinear2D(size=(7, 6)),
         nn.UpsamplingBilinear2D(size=(7, 6))),
        (RN.PixelShuffle(2), nn.PixelShuffle(2)),
        (RN.PixelUnshuffle(2), nn.PixelUnshuffle(2)),
        (RN.Flatten(), nn.Flatten()),
        (RN.Identity(), nn.Identity()),
    ]
    for mode in ("constant", "reflect", "replicate", "circular"):
        pairs.append((RN.Pad2D([1, 2, 2, 1], mode=mode, value=0.5),
                      nn.Pad2D([1, 2, 2, 1], mode=mode, value=0.5)))
    pairs.append((RN.ZeroPad2D([1, 0, 2, 1]), nn.ZeroPad2D([1, 0, 2, 1])))
    for ref_layer, port_layer in pairs:
        want = _ref(ref_layer(paddle.to_tensor(x)))
        got = _port(port_layer(torch.from_numpy(x)))
        assert got.shape == want.shape, type(port_layer).__name__
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        _port(F.pad(torch.from_numpy(x), [0, 0, 1, 1, 0, 0, 2, 0],
                    mode="reflect")),
        _ref(RF.pad(paddle.to_tensor(x), [0, 0, 1, 1, 0, 0, 2, 0],
                    mode="reflect")), **TOL)
    np.testing.assert_allclose(
        _port(F.zeropad2d(torch.from_numpy(x), [1, 2, 0, 3])),
        _ref(RF.zeropad2d(paddle.to_tensor(x), [1, 2, 0, 3])), **TOL)
    np.testing.assert_allclose(
        _port(nn.Unflatten(1, (2, 4))(torch.from_numpy(x))),
        _ref(RN.Unflatten(1, (2, 4))(paddle.to_tensor(x))), **TOL)


def test_containers_name_sublayers_as_the_reference():
    seq = nn.Sequential(nn.Conv2D(3, 4, 3), nn.ReLU(), nn.Identity())
    assert [k for k, _ in seq.named_parameters()] == ["0.weight", "0.bias"]
    assert isinstance(seq[1:], nn.Sequential) and len(seq[1:]) == 2
    named = nn.Sequential(("conv", nn.Conv2D(3, 4, 1)), ("act", nn.ReLU()))
    assert [k for k, _ in named.named_parameters()][0] == "conv.weight"
    ll = nn.LayerList([nn.ReLU()]).append(nn.GELU())
    assert len(ll) == 2
    ld = nn.LayerDict({"a": nn.ReLU()})
    assert "a" in ld
    pl = nn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    assert len(list(pl.parameters())) == 1


# ------------------------------------------------------------ activations
ACTIVATIONS = {
    "relu6": {}, "sigmoid": {}, "silu": {}, "swish": {}, "softsign": {},
    "tanhshrink": {}, "mish": {}, "log_sigmoid": {}, "log_softmax": {},
    "leaky_relu": dict(negative_slope=0.2), "elu": dict(alpha=0.7),
    "selu": {}, "celu": dict(alpha=1.3), "hardshrink": dict(threshold=0.4),
    "softshrink": dict(threshold=0.3), "hardsigmoid": {}, "hardswish": {},
    "hardtanh": dict(min=-0.5, max=0.7), "softplus": dict(beta=2.0,
                                                          threshold=3.0),
    "thresholded_relu": dict(threshold=0.2, value=-1.0),
    "rrelu": {}, "glu": dict(axis=1), "maxout": dict(groups=2),
    "gelu": {}, "relu": {}, "tanh": {}, "softmax": dict(axis=1),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_matches_reference(name):
    x = _rand(np.random.RandomState(len(name)), 3, 4, 5) * 3
    kw = ACTIVATIONS[name]
    want = _ref(getattr(RF, name)(paddle.to_tensor(x), **kw))
    got = _port(getattr(F, name)(torch.from_numpy(x), **kw))
    np.testing.assert_allclose(got, want, **TOL)


def test_prelu_in_place_and_gumbel():
    rng = np.random.RandomState(14)
    x, w = _rand(rng, 2, 3, 4), _rand(rng, 3)
    np.testing.assert_allclose(
        _port(F.prelu(torch.from_numpy(x), torch.from_numpy(w))),
        _ref(RF.prelu(paddle.to_tensor(x), paddle.to_tensor(w))), **TOL)
    t = torch.from_numpy(x.copy())
    assert F.relu_(t) is t and float(t.min()) == 0.0
    y = F.gumbel_softmax(torch.from_numpy(x), hard=True,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(y.sum(-1), torch.ones(2, 3))
    slope = F.rrelu(torch.from_numpy(-np.abs(x)), training=True,
                    generator=torch.Generator().manual_seed(0)) \
        / torch.from_numpy(-np.abs(x))
    assert float(slope.min()) >= 0.125 and float(slope.max()) < 1 / 3


@pytest.mark.parametrize("layer,args", [
    ("ReLU6", ()), ("SiLU", ()), ("Sigmoid", ()), ("Hardswish", ()),
    ("LeakyReLU", (0.1,)), ("ELU", (0.5,)), ("Softplus", ()),
    ("LogSoftmax", ()), ("GELU", (True,)), ("Mish", ()), ("GLU", ()),
])
def test_activation_layers_match_reference(layer, args):
    x = _rand(np.random.RandomState(15), 2, 4, 6) * 2
    want = _ref(getattr(RN, layer)(*args)(paddle.to_tensor(x)))
    got = _port(getattr(nn, layer)(*args)(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, **TOL)
