"""MobileNetV2 (counterpart of ``paddle_tpu/vision/models/mobilenet.py``):
its depthwise convolutions are ``Conv2D(groups=channels)``."""
from __future__ import annotations

import torch

from ..._device import resolve_device
from ...nn.layer import common as C
from ...nn.layer import conv as CV
from ...nn.layer import norm as N
from ._build import seed_weights
from ...nn.layer.layers import Layer

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(C.Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1):
        padding = (kernel_size - 1) // 2
        super().__init__(
            CV.Conv2D(in_planes, out_planes, kernel_size, stride=stride,
                      padding=padding, groups=groups, bias_attr=False),
            N.BatchNorm2D(out_planes), C.ReLU6())


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim),
            CV.Conv2D(hidden_dim, oup, 1, bias_attr=False),
            N.BatchNorm2D(oup)])
        self.conv = C.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        setting = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2],
                   [6, 64, 4, 2], [6, 96, 3, 1], [6, 160, 3, 2],
                   [6, 320, 1, 1]]
        input_channel = _make_divisible(32 * scale)
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        dev = resolve_device(device)
        with dev:
            features = [ConvBNReLU(3, input_channel, stride=2)]
            for t, c, n, s in setting:
                output_channel = _make_divisible(c * scale)
                for i in range(n):
                    features.append(InvertedResidual(
                        input_channel, output_channel, s if i == 0 else 1, t))
                    input_channel = output_channel
            features.append(ConvBNReLU(input_channel, self.last_channel,
                                       kernel_size=1))
            self.features = C.Sequential(*features)
            if with_pool:
                self.pool2d_avg = N.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = C.Sequential(
                    C.Dropout(0.2), C.Linear(self.last_channel, num_classes))
        seed_weights(self, dev, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights (zero-egress)")
    return MobileNetV2(scale=scale, **kwargs)
