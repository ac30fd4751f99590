"""``paddle.vision.models`` of the port (counterpart of
``paddle_tpu/vision/models``)."""
from .lenet import LeNet  # noqa: F401
from .mobilenet import MobileNetV2, mobilenet_v2  # noqa: F401
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from .sd_unet import (DDIMScheduler, SDUNetConfig,  # noqa: F401
                      UNet2DConditionModel, ddim_sample)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

__all__ = _resnet_all + ["LeNet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
                         "MobileNetV2", "mobilenet_v2", "SDUNetConfig",
                         "UNet2DConditionModel", "DDIMScheduler",
                         "ddim_sample"]
