"""Norm and pooling layers (counterpart of
``paddle_tpu/nn/layer/norm.py``). Weights start at 1 and biases at 0;
``weight_attr`` / ``bias_attr`` False drops them. BatchNorm's running
statistics are the f32 buffers ``_mean`` (0) and ``_variance`` (1), the
reference's names, so the weight carry moves them with the parameters."""
from __future__ import annotations

import torch

from ..._later import not_ported
from .. import functional as F
from .layers import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
    "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D"]


def _affine_params(module, n, weight_attr, bias_attr, kw):
    module.weight = (None if weight_attr is False else torch.nn.Parameter(
        torch.ones(n, **kw)))
    module.bias = (None if bias_attr is False else torch.nn.Parameter(
        torch.zeros(n, **kw)))


class RMSNorm(Layer):
    """The Llama-family norm: K1 forward, K6 backward (``F.rms_norm``)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self.epsilon}"


class LayerNorm(Layer):
    """``paddle.nn.LayerNorm``: weight 1 and bias 0 over
    ``normalized_shape`` (``weight_attr`` / ``bias_attr`` False drops
    them), through :func:`~paddle_tpu_torch.nn.functional.layer_norm`."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = (None if weight_attr is False else torch.nn.Parameter(
            torch.ones(self._normalized_shape, **kw)))
        self.bias = (None if bias_attr is False else torch.nn.Parameter(
            torch.zeros(self._normalized_shape, **kw)))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={list(self._normalized_shape)}, "
                f"epsilon={self._epsilon}")


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine_params(self, num_features, weight_attr, bias_attr,
                       dict(device=device, dtype=dtype))
        self.register_buffer("_mean", torch.zeros(
            num_features, device=device, dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=torch.float32))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm(num_channels, act=...)``."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, device=None, dtype=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return torch.relu(out) if self._act == "relu" else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm: its statistics span the ranks of a device
    mesh, which the port does not have yet (ROADMAP A7)."""

    def __init__(self, *args, **kwargs):
        not_ported("SyncBatchNorm (statistics across ranks)", "A7")()

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        not_ported("SyncBatchNorm.convert_sync_batchnorm", "A7")()


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        _affine_params(self, num_channels, weight_attr, bias_attr,
                       dict(device=device, dtype=dtype))

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)

    def extra_repr(self):
        return f"num_groups={self._num_groups}, epsilon={self._epsilon}"


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        # the reference keeps both or neither
        drop = weight_attr is False
        _affine_params(self, num_features, weight_attr,
                       False if drop else bias_attr,
                       dict(device=device, dtype=dtype))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self._args)


class SpectralNorm(Layer):
    """A weight divided by its largest singular value, estimated by
    ``power_iters`` steps of power iteration from the vectors ``weight_u``
    (h,) and ``weight_v`` (w,) (parameters that take no gradient; drawn
    from N(0, 1) with ``generator``). As in the reference, the iteration
    starts from them on every call and does not write them back."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", device=None, generator=None):
        super().__init__()
        self._dim, self._power_iters, self._epsilon = (dim, power_iters,
                                                       epsilon)
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        kw = dict(device=device, dtype=torch.float32)
        self.weight_u = torch.nn.Parameter(
            torch.empty(h, **kw).normal_(generator=generator),
            requires_grad=False)
        self.weight_v = torch.nn.Parameter(
            torch.empty(w, **kw).normal_(generator=generator),
            requires_grad=False)

    def forward(self, weight):
        mat = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                   -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self._power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._epsilon)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self._epsilon)
        return weight / (u @ mat @ v)


# -- pooling layers ----------------------------------------------------------
def _pool_layer(fname):
    class _Pool(Layer):
        def __init__(self, kernel_size=None, stride=None, padding=0,
                     **kwargs):
            super().__init__()
            self._kernel_size = kernel_size
            self._stride = stride
            self._padding = padding
            self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return getattr(F, fname)(x, self._kernel_size, self._stride,
                                     self._padding, **self._kwargs)

    _Pool.__name__ = _Pool.__qualname__ = fname
    return _Pool


MaxPool1D = _pool_layer("max_pool1d")
MaxPool2D = _pool_layer("max_pool2d")
MaxPool3D = _pool_layer("max_pool3d")
AvgPool1D = _pool_layer("avg_pool1d")
AvgPool2D = _pool_layer("avg_pool2d")
AvgPool3D = _pool_layer("avg_pool3d")


def _adaptive_pool_layer(fname):
    class _Pool(Layer):
        def __init__(self, output_size, **kwargs):
            super().__init__()
            self._output_size = output_size
            self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

        def forward(self, x):
            return getattr(F, fname)(x, self._output_size, **self._kwargs)

    _Pool.__name__ = _Pool.__qualname__ = fname
    return _Pool


AdaptiveAvgPool1D = _adaptive_pool_layer("adaptive_avg_pool1d")
AdaptiveAvgPool2D = _adaptive_pool_layer("adaptive_avg_pool2d")
AdaptiveAvgPool3D = _adaptive_pool_layer("adaptive_avg_pool3d")
AdaptiveMaxPool1D = _adaptive_pool_layer("adaptive_max_pool1d")
AdaptiveMaxPool2D = _adaptive_pool_layer("adaptive_max_pool2d")
AdaptiveMaxPool3D = _adaptive_pool_layer("adaptive_max_pool3d")
