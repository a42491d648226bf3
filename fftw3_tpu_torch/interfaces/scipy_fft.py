"""scipy.fft-compatible interface over the port.

Mirrors ``scipy.fft``'s public surface: the complex/real FFT family plus
DCT/DST I-IV with scipy's norm conventions ("backward" default, "ortho",
"forward"), and the n-dimensional dctn/dstn variants.  All transforms route
through the plan-cached functional API (FFTW-convention unnormalized
transforms with the scipy factors applied on top, as scipy wraps
pocketfft).  ``workers`` and ``overwrite_x`` are accepted and ignored:
PyTorch owns memory and scheduling.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import api as _api

# complex/real FFT family — scipy norm semantics match numpy's
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

from .numpy_fft import hfft, ihfft  # noqa: E402,F401


def _norm_scale(norm, den: float) -> float:
    if norm in (None, "backward"):
        return 1.0
    if norm == "forward":
        return 1.0 / den
    if norm == "ortho":
        return 1.0 / np.sqrt(den)
    raise ValueError(f"bad norm {norm!r}")


def _boundary(type_: int, N: int, is_dct: bool, ortho: bool):
    """(pre, post) host float64 vectors: scipy's ``orthogonalize``
    rescaling of the boundary input / output elements."""
    pre = np.ones(N)
    post = np.ones(N)
    if ortho:
        rt2 = np.sqrt(2.0)
        if is_dct:
            if type_ == 1:
                pre[0] = pre[-1] = rt2
                post[0] = post[-1] = 1.0 / rt2
            elif type_ == 2:
                post[0] = 1.0 / rt2
            elif type_ == 3:
                pre[0] = rt2
        else:
            if type_ == 2:
                post[-1] = 1.0 / rt2
            elif type_ == 3:
                pre[-1] = rt2
    return pre, post


@lru_cache(maxsize=256)
def _factors(type_: int, N: int, is_dct: bool, ortho: bool, norm,
             dtype: torch.dtype, device: str):
    """(pre, post) factor vectors on `device` in `dtype`, each None where
    it is all ones: the boundary rescaling and the uniform norm scale,
    computed on the host in float64 and rounded once; built once per
    (type, N, norm, dtype, device)."""
    pre, post = _boundary(type_, N, is_dct, ortho)
    post = post * _norm_scale(norm, _forward_den(type_, N, is_dct))
    return tuple(None if np.all(v == 1.0)
                 else torch.from_numpy(v).to(dtype).to(device)
                 for v in (pre, post))


def _along(x: torch.Tensor, axis: int, vec: torch.Tensor) -> torch.Tensor:
    """`x` times `vec` broadcast along `axis`."""
    shp = [1] * x.dim()
    shp[axis % x.dim()] = vec.numel()
    return x * vec.reshape(shp)


def _trig_transform(api_fn, x, type, n, axis, norm, orthogonalize,
                    is_dct: bool):
    """Shared scipy dct/dst semantics: ``orthogonalize`` (defaulting to
    True under norm='ortho', scipy >= 1.8) rescales the boundary input /
    output elements by sqrt(2) factors independent of the uniform norm
    scaling, exactly how scipy layers it over pocketfft."""
    x = _api._tensor(x)
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    if n is not None:
        x = _api._fit_length(x, n, axis)
    N = x.shape[axis % x.dim()]
    if type not in (1, 2, 3, 4):
        raise ValueError(f"bad {'DCT' if is_dct else 'DST'} type {type}")
    if is_dct and type == 1 and N < 2:
        raise ValueError("DCT-I needs n >= 2")
    ortho = (norm == "ortho") if orthogonalize is None \
        else bool(orthogonalize)
    pre, post = _factors(type, N, is_dct, ortho, norm, x.dtype,
                         _api._device_key(x.device))
    if pre is not None:
        x = _along(x, axis, pre)
    y = api_fn(x, type, axis, None)
    return y if post is None else _along(y, axis, post)


def dct(x, type: int = 2, n=None, axis: int = -1, norm=None,
        overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _trig_transform(_api.dct, x, type, n, axis, norm,
                           orthogonalize, is_dct=True)


def dst(x, type: int = 2, n=None, axis: int = -1, norm=None,
        overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _trig_transform(_api.dst, x, type, n, axis, norm,
                           orthogonalize, is_dct=False)


def _forward_den(type_: int, N: int, is_dct: bool) -> float:
    """Logical size: the "forward" norm divides by it (scipy convention)."""
    if type_ == 1:
        return 2.0 * (N - 1) if is_dct else 2.0 * (N + 1)
    return 2.0 * N


_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def _inverse(fn, x, type, n, axis, norm, orthogonalize, is_dct):
    it = _INV_TYPE[type]
    x = _api._tensor(x)
    N = x.shape[axis % x.dim()] if n is None else n
    if norm == "ortho":
        return fn(x, it, n, axis, "ortho", orthogonalize=orthogonalize)
    y = fn(x, it, n, axis, None, orthogonalize=orthogonalize)
    if norm == "forward":
        return y
    return y / _forward_den(it, N, is_dct)


def idct(x, type: int = 2, n=None, axis: int = -1, norm=None,
         overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _inverse(dct, x, type, n, axis, norm, orthogonalize, True)


def idst(x, type: int = 2, n=None, axis: int = -1, norm=None,
         overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _inverse(dst, x, type, n, axis, norm, orthogonalize, False)


def _nd(fn1, x, type, axes, norm, orthogonalize=None):
    x = _api._tensor(x)
    axes = tuple(range(x.dim())) if axes is None else \
        tuple(a % x.dim() for a in axes)
    for a in axes:
        x = fn1(x, type, None, a, norm, orthogonalize=orthogonalize)
    return x


def dctn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
         workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(dct, x, type, axes, norm, orthogonalize)


def idctn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
          workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(idct, x, type, axes, norm, orthogonalize)


def dstn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
         workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(dst, x, type, axes, norm, orthogonalize)


def idstn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
          workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(idst, x, type, axes, norm, orthogonalize)
