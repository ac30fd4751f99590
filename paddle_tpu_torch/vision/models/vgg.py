"""VGG (counterpart of ``paddle_tpu/vision/models/vgg.py``)."""
from __future__ import annotations

import torch

from ..._device import resolve_device
from ...nn.layer import common as C
from ...nn.layer import conv as CV
from ...nn.layer import norm as N
from ._build import seed_weights
from ...nn.layer.layers import Layer

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(N.MaxPool2D(2, 2))
        else:
            layers.append(CV.Conv2D(in_channels, v, 3, padding=1))
            if batch_norm:
                layers.append(N.BatchNorm2D(v))
            layers.append(C.ReLU())
            in_channels = v
    return C.Sequential(*layers)


class VGG(Layer):
    """``features`` is built by :func:`make_layers`; built under ``with
    device:`` it lands there (the ``vgg*`` constructors do so)."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, generator=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        dev = resolve_device(device)
        with dev:
            if with_pool:
                self.avgpool = N.AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = C.Sequential(
                    C.Linear(512 * 7 * 7, 4096), C.ReLU(), C.Dropout(),
                    C.Linear(4096, 4096), C.ReLU(), C.Dropout(),
                    C.Linear(4096, num_classes))
        seed_weights(self.to(dev), dev, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, device=None, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weights (zero-egress)")
    dev = resolve_device(device)
    with dev:
        features = make_layers(cfgs[cfg], batch_norm)
    return VGG(features, device=dev, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
