"""``paddle.signal``: the short-time Fourier transform and its inverse
(counterpart of ``paddle_tpu/signal.py``). Framing, windowing and the
overlap-add are real-valued torch ops, the transforms
:mod:`paddle_tpu_torch.fft`'s; everything carries autograd."""
from __future__ import annotations

import math

import torch

from . import fft as _fft
from .tensor._helpers import ensure_tensor

__all__ = ["stft", "istft"]

_PAD_MODES = ("constant", "reflect", "symmetric", "edge", "wrap")


def _pad_last(x, p, mode):
    """``x`` padded by ``p`` on both ends of its last dim, numpy's
    ``pad`` modes."""
    if mode not in _PAD_MODES:
        raise ValueError(f"stft: pad_mode must be one of {_PAD_MODES}, "
                         f"got {mode!r}")
    if mode == "constant":
        return torch.nn.functional.pad(x, (p, p))
    n = x.shape[-1]
    i = torch.arange(-p, n + p, device=x.device)
    if mode == "edge":
        i = i.clamp(0, n - 1)
    elif mode == "wrap":
        i = i % n
    elif mode == "reflect":
        period = max(2 * (n - 1), 1)
        i = i.abs() % period
        i = torch.where(i >= n, period - i, i)
    else:  # symmetric: the edge sample repeats
        i = i % (2 * n)
        i = torch.where(i >= n, 2 * n - 1 - i, i)
    return x.index_select(-1, i)


def _window(window, win_length, n_fft, dtype, device):
    """The window (a rectangle of ``win_length`` when None), zero-padded
    to ``n_fft`` and centred, as the reference's."""
    w = (torch.ones(win_length, dtype=dtype, device=device)
         if window is None else ensure_tensor(window))
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        w = torch.nn.functional.pad(w, (left, n_fft - win_length - left))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """(..., T) -> (..., n_fft // 2 + 1, n_frames) complex (``onesided``;
    n_fft bins otherwise): frames of ``n_fft`` every ``hop_length``
    samples (after padding ``n_fft // 2`` each side when ``center``),
    windowed, divided by ``sqrt(n_fft)`` when ``normalized``."""
    x = ensure_tensor(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if center:
        x = _pad_last(x, n_fft // 2, pad_mode)
    frames = x.unfold(-1, n_fft, hop_length)  # (..., n_frames, n_fft)
    frames = frames * _window(window, win_length, n_fft, frames.dtype,
                              frames.device)
    if normalized:
        frames = frames / math.sqrt(n_fft)
    spec = _fft.rfft(frames) if onesided else _fft.fft(frames)
    return spec.transpose(-1, -2)


def _overlap_add(frames, hop_length):
    """Sum of (N, n_frames, n_fft) real frames placed every
    ``hop_length`` samples: (N, n_fft + hop_length * (n_frames - 1))."""
    n, n_frames, n_fft = frames.shape
    t_len = n_fft + hop_length * (n_frames - 1)
    out = torch.nn.functional.fold(frames.transpose(1, 2), (1, t_len),
                                   (1, n_fft), stride=(1, hop_length))
    return out.reshape(n, t_len)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse of :func:`stft` by windowed overlap-add: each frame's
    inverse transform times the window, summed, divided by the summed
    squared window (at least 1e-10), the centre padding cut away, then
    cut to ``length``."""
    x = ensure_tensor(x)
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    if return_complex and onesided:
        raise ValueError("istft: return_complex=True requires "
                         "onesided=False")
    spec = x.transpose(-1, -2)  # (..., n_frames, F)
    if onesided:
        frames = _fft.irfft(spec, n=n_fft)
    else:
        frames = _fft.ifft(spec)
        if not return_complex:
            frames = frames.real
    if normalized:
        frames = frames * math.sqrt(n_fft)
    real_dtype = frames.real.dtype if frames.is_complex() else frames.dtype
    w = _window(window, win_length, n_fft, real_dtype, frames.device)
    lead, (n_frames, _) = frames.shape[:-2], frames.shape[-2:]
    flat = (frames * w).reshape(-1, n_frames, n_fft)
    if flat.is_complex():
        out = torch.complex(_overlap_add(flat.real, hop_length),
                            _overlap_add(flat.imag, hop_length))
    else:
        out = _overlap_add(flat, hop_length)
    norm = _overlap_add((w * w).expand(1, n_frames, n_fft), hop_length)[0]
    out = (out / torch.clamp(norm, min=1e-10)).reshape(*lead, -1)
    if center:
        out = out[..., n_fft // 2:out.shape[-1] - n_fft // 2]
    if length is not None:
        out = out[..., :length]
    return out
