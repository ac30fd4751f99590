"""``paddle.vision`` of the port (counterpart of ``paddle_tpu/vision``):
the models. The weight carry is ``nlp.convert``'s, re-exported here: it
moves parameters and BatchNorm's running statistics, transposes Linear
weights and leaves conv weights as they are. ``vision.ops``, the
transforms and the datasets are still to come (ROADMAP A9)."""
from . import models
from ..nlp.convert import load_paddle_tpu_arrays, paddle_tpu_arrays_to_port
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ["models", "load_paddle_tpu_arrays", "paddle_tpu_arrays_to_port",
           "set_image_backend", "get_image_backend"] + _models_all


def set_image_backend(backend):
    """Accepted and not read, as the reference's."""


def get_image_backend():
    return "numpy"
