"""numpy.fft-compatible interface over the port.

Function-for-function mirror of ``numpy.fft``'s public surface, with
numpy's norm conventions, on torch tensors (numpy arrays and array-likes go
to ``config.device``).
"""
from __future__ import annotations

import numpy as _np

from .. import api as _api

fft = _api.fft
ifft = _api.ifft
fft2 = _api.fft2
ifft2 = _api.ifft2
fftn = _api.fftn
ifftn = _api.ifftn
rfft = _api.rfft
irfft = _api.irfft
rfft2 = _api.rfft2
irfft2 = _api.irfft2
rfftn = _api.rfftn
irfftn = _api.irfftn
fftfreq = _api.fftfreq
rfftfreq = _api.rfftfreq
fftshift = _api.fftshift
ifftshift = _api.ifftshift


def hfft(x, n=None, axis=-1, norm=None):
    """Hermitian-input FFT (numpy.fft.hfft semantics): the c2r transform of
    conj(x) — c2r IS the unnormalized Hermitian-to-real DFT — with numpy's
    norm factors (backward: 1, ortho: 1/sqrt(n), forward: 1/n)."""
    x = _api._as_complex(x)
    if n is None:
        n = 2 * (x.shape[axis] - 1)
    # irfft applies the "backward" 1/n; undo it to get the raw c2r, then
    # apply numpy's hfft scaling
    y = irfft(x.conj(), n, axis, None) * n
    scale = {None: 1.0, "backward": 1.0,
             "ortho": 1.0 / _np.sqrt(n), "forward": 1.0 / n}[norm]
    return _api._scaled(y, scale)


def ihfft(x, n=None, axis=-1, norm=None):
    """Inverse of hfft: conj(rfft(x)) with the inverse norm factors."""
    x = _api._tensor(x)
    if n is None:
        n = x.shape[axis]
    y = rfft(x, n, axis, None).conj().resolve_conj()
    scale = {None: 1.0 / n, "backward": 1.0 / n,
             "ortho": 1.0 / _np.sqrt(n), "forward": 1.0}[norm]
    return _api._scaled(y, scale)
