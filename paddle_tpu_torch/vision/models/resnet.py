"""ResNet family (counterpart of ``paddle_tpu/vision/models/resnet.py``;
config #1 of BASELINE.md, ResNet-50 trained eagerly). Convolutions,
BatchNorm and pooling are the port's layers (cuDNN on the card: the
reference has no Pallas kernel on this path). Built on ``device``
(default ``cuda``) with weights drawn from ``generator``
(``models/_build.py``); layer names are the reference's, so its
``state_dict()`` carries across with ``vision.load_paddle_tpu_arrays``,
BatchNorm's ``_mean`` / ``_variance`` buffers included."""
from __future__ import annotations

import torch

from ..._device import resolve_device
from ...nn.layer import common as C
from ...nn.layer import conv as CV
from ...nn.layer import norm as N
from ._build import seed_weights
from ...nn.layer.layers import Layer

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
    "resnext101_32x4d"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or N.BatchNorm2D
        self.conv1 = CV.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = C.ReLU()
        self.conv2 = CV.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or N.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = CV.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = CV.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = CV.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = C.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, generator=None):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        dev = resolve_device(device)
        with dev:
            self.conv1 = CV.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                   bias_attr=False)
            self.bn1 = N.BatchNorm2D(self.inplanes)
            self.relu = C.ReLU()
            self.maxpool = N.MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = N.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = C.Linear(512 * block.expansion, num_classes)
        seed_weights(self, dev, generator)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = C.Sequential(
                CV.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                N.BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width))
        return C.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights unavailable in this zero-egress environment")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs["groups"] = 32
    kwargs["width"] = 4
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)
