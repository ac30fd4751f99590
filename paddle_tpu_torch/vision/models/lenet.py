"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``)."""
from __future__ import annotations

import torch

from ..._device import resolve_device
from ...nn.layer import common as C
from ...nn.layer import conv as CV
from ...nn.layer import norm as N
from ._build import seed_weights
from ...nn.layer.layers import Layer

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, device=None, generator=None):
        super().__init__()
        self.num_classes = num_classes
        dev = resolve_device(device)
        with dev:
            self.features = C.Sequential(
                CV.Conv2D(1, 6, 3, stride=1, padding=1), C.ReLU(),
                N.MaxPool2D(2, 2),
                CV.Conv2D(6, 16, 5, stride=1, padding=0), C.ReLU(),
                N.MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = C.Sequential(C.Linear(400, 120), C.Linear(120, 84),
                                       C.Linear(84, num_classes))
        seed_weights(self, dev, generator)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
