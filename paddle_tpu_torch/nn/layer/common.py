"""Common layers of the port (counterpart of
``paddle_tpu/nn/layer/common.py``).

``Linear`` and ``Embedding`` are ``torch.nn``'s, with their forward
through the functionals that hold amp's cast seam
(``nn/functional/common.py``). Subclasses, so ``isinstance(m,
torch.nn.Linear)`` still holds (the weight carry transposes by it).
``Dropout`` is paddle's, over ``F.dropout``. The containers are
``torch.nn``'s (``Sequential``, ``ModuleList``, ``ModuleDict``,
``ParameterList``) under paddle's names, so sublayers are named as in the
reference (``"0"``, ``"1"``, ...) and state-dict keys carry across. The
reshaping, padding and resampling layers and the activation layers call
the port's functionals.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ... import amp
from ...amp import amp_state
from ..functional import activation as _act
from ..functional.common import (alpha_dropout, bilinear, channel_shuffle,
                                 cosine_similarity, dropout, dropout2d,
                                 dropout3d, fold, interpolate, pad,
                                 pixel_shuffle, pixel_unshuffle,
                                 torch_linear, unfold)
from .layers import Layer

__all__ = [
    "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Unflatten", "Identity",
    "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D", "Upsample",
    "UpsamplingNearest2D", "UpsamplingBilinear2D", "PixelShuffle",
    "PixelUnshuffle", "ChannelShuffle", "CosineSimilarity", "Bilinear",
    "Unfold", "Fold", "Sequential", "LayerList", "LayerDict",
    "ParameterList", "ReLU", "ReLU6", "GELU", "SiLU", "Swish", "Sigmoid",
    "Tanh", "Softmax", "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU",
    "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
    "Softplus", "Softsign", "Tanhshrink", "ThresholdedReLU", "Mish",
    "PReLU", "RReLU", "Maxout", "GLU", "LogSigmoid"]


class Linear(torch.nn.Linear, Layer):
    """``torch.nn.Linear`` (weight (out, in)) under amp's ``linear`` rule
    and the reference's mixed-dtype promotion."""

    def forward(self, x):
        return torch_linear(x, self.weight, self.bias)


class Embedding(torch.nn.Embedding, Layer):
    """``torch.nn.Embedding`` under amp's ``embedding`` rule (O2 reads the
    table in the amp dtype)."""

    def forward(self, x):
        w = self.weight
        if amp_state.enabled:
            (w,) = amp.cast_inputs_for_op("embedding", w)
        return torch.nn.functional.embedding(
            x, w, self.padding_idx, self.max_norm, self.norm_type,
            self.scale_grad_by_freq, self.sparse)


class Dropout(Layer):
    """``paddle.nn.Dropout``: :func:`~paddle_tpu_torch.nn.functional.dropout`
    in training mode (``self.training``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return alpha_dropout(x, self.p, self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, tuple(shape)

    def forward(self, x):
        return x.unflatten(self.axis, self.shape)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadN):
    pass


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Upsample(Layer):
    """``paddle.nn.Upsample`` over
    :func:`~paddle_tpu_torch.nn.functional.interpolate`."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return interpolate(x, self.size, self.scale_factor, self.mode,
                           self.align_corners, self.align_mode,
                           self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return channel_shuffle(x, self.groups, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """``paddle.nn.Bilinear``: weight (out, in1, in2) Xavier-normal and
    bias (out,) zeros, the reference's defaults."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr)
        self.bias = (self.create_parameter((out_features,), attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x1, x2):
        return bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return fold(x, *self.args)


# -- containers: torch's, taking paddle's constructor forms -----------------
class Sequential(torch.nn.Sequential, Layer):
    """Layers in order, named ``"0"``, ``"1"``, ... (or by an
    ``OrderedDict``, or by ``(name, layer)`` pairs), as the reference's."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
            return
        named = OrderedDict()
        for i, item in enumerate(layers):
            if isinstance(item, (tuple, list)) and len(item) == 2 \
                    and isinstance(item[0], str):
                named[item[0]] = item[1]
            else:
                named[str(i)] = item
        super().__init__(named)


class LayerList(torch.nn.ModuleList, Layer):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(torch.nn.ModuleDict, Layer):
    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(torch.nn.ParameterList, Layer):
    def __init__(self, parameters=None):
        super().__init__(parameters)


# -- activation layers: each calls its functional ---------------------------
def _act_layer(fname):
    class _Act(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            self._args, self._kwargs = args, kwargs

        def forward(self, x):
            return getattr(_act, fname)(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = fname
    return _Act


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return torch.relu(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return _act.gelu(x, self._approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return _act.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return _act.log_softmax(x, self._axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return _act.leaky_relu(x, self._slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__()
        self._data_format = data_format
        self.weight = torch.nn.Parameter(torch.full(
            (num_parameters,), float(init), device=device, dtype=dtype))

    def forward(self, x):
        return _act.prelu(x, self.weight, self._data_format)


ReLU6 = _act_layer("relu6")
SiLU = _act_layer("silu")
Swish = _act_layer("swish")
Sigmoid = _act_layer("sigmoid")
Tanh = _act_layer("tanh")
ELU = _act_layer("elu")
SELU = _act_layer("selu")
CELU = _act_layer("celu")
Hardswish = _act_layer("hardswish")
Hardsigmoid = _act_layer("hardsigmoid")
Hardtanh = _act_layer("hardtanh")
Hardshrink = _act_layer("hardshrink")
Softshrink = _act_layer("softshrink")
Softplus = _act_layer("softplus")
Softsign = _act_layer("softsign")
Tanhshrink = _act_layer("tanhshrink")
ThresholdedReLU = _act_layer("thresholded_relu")
Mish = _act_layer("mish")
RReLU = _act_layer("rrelu")
Maxout = _act_layer("maxout")
GLU = _act_layer("glu")
LogSigmoid = _act_layer("log_sigmoid")
