"""``paddle.fft``: discrete Fourier transforms on ``torch.fft``
(counterpart of ``paddle_tpu/fft.py``). ``norm`` is ``"backward"``,
``"ortho"`` or ``"forward"``, numpy's meanings. The transforms run on
the input's device and carry autograd. (The reference moves transforms
to the host where its TPU backend lacks complex dtypes; the port has no
such path.)"""
from __future__ import annotations

import torch

from ._device import resolve_device
from .core.dtype import to_torch_dtype
from .tensor._helpers import apply, axes_arg, ensure_tensor  # noqa: F401

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]


def _norm(norm):
    if norm not in ("backward", "ortho", "forward"):
        raise ValueError(
            f"norm must be 'backward', 'ortho' or 'forward', got {norm!r}")
    return norm


def _wrap1(op_name):
    torch_fn = getattr(torch.fft, op_name)

    def op(x, n=None, axis=-1, norm="backward", name=None):
        # ihfft's result is a lazily conjugated view: materialize it
        return torch_fn(ensure_tensor(x), n=n, dim=axis,
                        norm=_norm(norm)).resolve_conj()

    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = f"paddle.fft.{op_name}(x, n=None, axis=-1, norm='backward')"
    return op


def _wrap_nd(op_name, default_axes):
    torch_fn = getattr(torch.fft, op_name)

    def op(x, s=None, axes=default_axes, norm="backward", name=None):
        ax = axes_arg(axes)
        return torch_fn(ensure_tensor(x), s=None if s is None else tuple(s),
                        dim=ax, norm=_norm(norm))

    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = (f"paddle.fft.{op_name}(x, s=None, axes={default_axes}, "
                  f"norm='backward')")
    return op


fft = _wrap1("fft")
ifft = _wrap1("ifft")
rfft = _wrap1("rfft")
irfft = _wrap1("irfft")
hfft = _wrap1("hfft")
ihfft = _wrap1("ihfft")

fft2 = _wrap_nd("fft2", (-2, -1))
ifft2 = _wrap_nd("ifft2", (-2, -1))
rfft2 = _wrap_nd("rfft2", (-2, -1))
irfft2 = _wrap_nd("irfft2", (-2, -1))
fftn = _wrap_nd("fftn", None)
ifftn = _wrap_nd("ifftn", None)
rfftn = _wrap_nd("rfftn", None)
irfftn = _wrap_nd("irfftn", None)


def _freq(torch_fn, n, d, dtype):
    out = torch_fn(int(n), d=float(d), device=resolve_device(None))
    return out if dtype is None else out.to(to_torch_dtype(dtype))


def fftfreq(n, d=1.0, dtype=None, name=None):
    """Sample frequencies of an ``n``-point transform, on the current
    place's device (float32 unless ``dtype``)."""
    return _freq(torch.fft.fftfreq, n, d, dtype)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freq(torch.fft.rfftfreq, n, d, dtype)


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(ensure_tensor(x), dim=axes_arg(axes))


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(ensure_tensor(x), dim=axes_arg(axes))
