"""Drop-in interface modules (the role pyfftw.interfaces plays for FFTW):
``numpy_fft`` mirrors ``numpy.fft``; ``scipy_fft`` mirrors ``scipy.fft``
(including DCT/DST with scipy norm conventions).  Both route through the
plan-cached functional API, so repeated same-shape calls on one device
reuse their plans.
"""
from . import numpy_fft, scipy_fft  # noqa: F401
