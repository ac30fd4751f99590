"""``paddle_tpu_torch.fft`` and ``signal`` held against paddle_tpu's on the
CPU: every transform of the ``fft.txt`` manifest (each ``norm`` among
the cases), the frequency and shift helpers, ``stft`` for every
``norm`` / ``center`` / ``pad_mode`` / ``onesided`` combination the
reference takes, ``istft`` back to the signal, and gradients through
``stft``'s magnitude and ``irfft(rfft(x))``.

Tolerance: ``1e-4`` absolute and relative on values of order 10 (f32
transforms of 8-64 points; pocketfft against PyTorch's, other butterfly
orders), ``1e-5`` on the exact helpers (frequencies, shifts)."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.fft as RFFT
import paddle_tpu.signal as RSIG
from paddle_tpu_torch import fft, signal
from paddle_tpu_torch.core import place as _place

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _cpu_place():
    import paddle_tpu_torch as PT

    saved = _place._current
    PT.set_device("cpu")
    yield
    _place._current = saved


def _x(seed, *shape, complex_=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.randn(*shape)).astype(np.complex64)
    return x


NORMS = ("backward", "ortho", "forward")
# name: (complex input, kwargs)
CASES = {
    "fft": (True, dict(n=10, axis=0)), "ifft": (True, dict()),
    "rfft": (False, dict(axis=1)), "irfft": (True, dict(n=14)),
    "hfft": (True, dict()), "ihfft": (False, dict(n=6)),
    "fft2": (True, dict()), "ifft2": (True, dict(s=(4, 6))),
    "rfft2": (False, dict(axes=(0, 2))), "irfft2": (True, dict()),
    "fftn": (True, dict(axes=(1, 2))), "ifftn": (True, dict()),
    "rfftn": (False, dict()), "irfftn": (True, dict(s=(3, 4, 10))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_reference(name):
    cplx, kw = CASES[name]
    norm = NORMS[sorted(CASES).index(name) % 3]
    x = _x(1, 3, 4, 8, complex_=cplx)
    want = getattr(RFFT, name)(P.to_tensor(x), norm=norm, **kw).numpy()
    got = getattr(fft, name)(torch.from_numpy(x), norm=norm, **kw)
    assert got.dtype == (torch.complex64 if np.iscomplexobj(want)
                         else torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_freqs_shifts_and_norm_check_match_reference():
    for name in ("fftfreq", "rfftfreq"):
        np.testing.assert_allclose(
            getattr(fft, name)(9, d=0.5).numpy(),
            getattr(RFFT, name)(9, d=0.5).numpy(), rtol=1e-5, atol=1e-5)
    x = _x(2, 4, 5)
    for name in ("fftshift", "ifftshift"):
        for axes in (None, (1,)):
            np.testing.assert_array_equal(
                getattr(fft, name)(torch.from_numpy(x), axes).numpy(),
                getattr(RFFT, name)(P.to_tensor(x), axes).numpy())
    with pytest.raises(ValueError, match="norm"):
        fft.fft(torch.from_numpy(x), norm="none")


def test_irfft_of_rfft_grads_match_reference():
    x = _x(3, 2, 16)
    w = _x(4, 2, 16)
    rx = P.to_tensor(x, stop_gradient=False)
    (RFFT.irfft(RFFT.rfft(rx, norm="ortho"), n=16, norm="ortho")
     * P.to_tensor(w)).sum().backward()
    px = torch.tensor(x, requires_grad=True)
    (fft.irfft(fft.rfft(px, norm="ortho"), n=16, norm="ortho")
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), rx.grad.numpy(), **TOL)


STFT = [(n, c, p, o) for n in (False, True) for c in (True, False)
        for p in ("reflect", "constant") for o in (True, False)
        if c or p == "reflect"]


@pytest.mark.parametrize("normalized,center,pad_mode,onesided", STFT,
                         ids=[f"n{int(n)}-c{int(c)}-{p}-o{int(o)}"
                              for n, c, p, o in STFT])
def test_stft_and_istft_match_reference(normalized, center, pad_mode,
                                        onesided):
    x = _x(5, 2, 64)
    win = np.hanning(12).astype(np.float32)
    kw = dict(n_fft=16, hop_length=4, win_length=12, center=center,
              normalized=normalized, onesided=onesided)
    want = RSIG.stft(P.to_tensor(x), window=P.to_tensor(win),
                     pad_mode=pad_mode, **kw)
    got = signal.stft(torch.from_numpy(x), window=torch.from_numpy(win),
                      pad_mode=pad_mode, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # the inverse of the reference's spectrum, both packages
    back_ref = RSIG.istft(want, window=P.to_tensor(win), length=64,
                          **kw).numpy()
    back = signal.istft(got, window=torch.from_numpy(win), length=64, **kw)
    np.testing.assert_allclose(back.numpy(), back_ref, **TOL)
    if center:  # every sample lies under a window: the round trip holds
        np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)


def test_istft_return_complex_and_default_window_match_reference():
    x = _x(6, 1, 48, complex_=True)
    kw = dict(n_fft=8, hop_length=2, onesided=False)
    spec_ref = RSIG.stft(P.to_tensor(x.real.copy()), **kw)
    spec = signal.stft(torch.from_numpy(x.real.copy()), **kw)
    np.testing.assert_allclose(spec.numpy(), spec_ref.numpy(), **TOL)
    want = RSIG.istft(spec_ref, return_complex=True, **kw).numpy()
    got = signal.istft(spec, return_complex=True, **kw)
    assert got.is_complex()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="onesided"):
        signal.istft(spec, n_fft=8, return_complex=True)


def test_stft_magnitude_grads_match_reference():
    x = _x(7, 2, 40)
    w = np.hanning(16).astype(np.float32)
    rx = P.to_tensor(x, stop_gradient=False)
    RSIG.stft(rx, 16, 4, window=P.to_tensor(w)).abs().sum().backward()
    px = torch.tensor(x, requires_grad=True)
    signal.stft(px, 16, 4, window=torch.from_numpy(w)).abs().sum() \
        .backward()
    np.testing.assert_allclose(px.grad.numpy(), rx.grad.numpy(), **TOL)
