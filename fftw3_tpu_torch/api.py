"""Public API — the port of ``fftw3_tpu/api.py``.

Two surfaces on PyTorch tensors:

1. **FFTW-style planned API** mirroring ``fftw3.h``: ``plan_dft*``,
   ``plan_many_dft``, ``plan_dft_r2c*``, ``plan_dft_c2r*`` and
   ``plan_r2r*`` build a :class:`Plan` for a device (``device=``, default
   ``config.device``), ``execute`` runs it; wisdom moves to and from
   strings, files, filenames and callbacks; ``flops``/``cost``/
   ``estimate_cost`` and the ``fftw3.h`` shims.  Transforms are
   unnormalized, like FFTW's.
2. **numpy-style functional API** (``fft``, ``ifft``, ``rfftn``, ``dct``,
   ...) with numpy/scipy norm conventions, plan-cached per (kind, shape,
   axes, sign, dtype, device, flags).  A torch tensor runs on its own
   device; a numpy array or array-like goes to ``config.device``.
"""
from __future__ import annotations

import os
import threading
from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import config
from . import plan as plan_mod
from . import planner as planner_mod
from . import kinds as K
from .kinds import BACKWARD, ESTIMATE, FORWARD, Kind

Plan = plan_mod.Plan
Problem = plan_mod.Problem

_lock = threading.Lock()


def _rdtype_of(dtype) -> str:
    dt = np.dtype(dtype)
    if dt in (np.complex64, np.float32):
        return "float32"
    if dt in (np.complex128, np.float64):
        return "float64"
    raise ValueError(f"unsupported dtype {dtype}")


def _axes_tuple(shape, axes) -> Tuple[int, ...]:
    if axes is None:
        return tuple(range(len(shape)))
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


def plan_dft(shape: Sequence[int], axes=None, sign: int = FORWARD,
             flags: int = ESTIMATE, dtype="complex64", device=None) -> Plan:
    """Complex DFT plan over `axes` of tensors of `shape` (plan_dft
    analog), built for `device`."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="c2c",
                   sign=sign, rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_dft_1d(n: int, sign: int = FORWARD, flags: int = ESTIMATE,
                dtype="complex64", device=None) -> Plan:
    return plan_dft((n,), (0,), sign, flags, dtype, device)


def plan_dft_2d(n0: int, n1: int, sign: int = FORWARD, flags: int = ESTIMATE,
                dtype="complex64", device=None) -> Plan:
    return plan_dft((n0, n1), (0, 1), sign, flags, dtype, device)


def plan_dft_3d(n0: int, n1: int, n2: int, sign: int = FORWARD,
                flags: int = ESTIMATE, dtype="complex64",
                device=None) -> Plan:
    return plan_dft((n0, n1, n2), (0, 1, 2), sign, flags, dtype, device)


def plan_many_dft(n: Sequence[int], howmany: int, sign: int = FORWARD,
                  flags: int = ESTIMATE, dtype="complex64",
                  device=None) -> Plan:
    """Batched DFT (advanced 'many' API analog): the batch is a leading
    vector dimension."""
    n = tuple(n)
    shape = (howmany,) + n
    axes = tuple(range(1, len(n) + 1))
    return plan_dft(shape, axes, sign, flags, dtype, device)


def plan_dft_r2c(shape: Sequence[int], axes=None, flags: int = ESTIMATE,
                 dtype="float32", device=None) -> Plan:
    """Real-input DFT plan over `axes` of real tensors of `shape`: the last
    transform axis keeps n//2+1 bins (FFTW's rdft2 layout)."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="r2c",
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_dft_r2c_1d(n: int, flags: int = ESTIMATE, dtype="float32",
                    device=None) -> Plan:
    return plan_dft_r2c((n,), (0,), flags, dtype, device)


def plan_dft_r2c_2d(n0: int, n1: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_r2c((n0, n1), (0, 1), flags, dtype, device)


def plan_dft_r2c_3d(n0: int, n1: int, n2: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_r2c((n0, n1, n2), (0, 1, 2), flags, dtype, device)


def plan_dft_c2r(shape: Sequence[int], axes=None, flags: int = ESTIMATE,
                 dtype="float32", device=None) -> Plan:
    """Real-output inverse of :func:`plan_dft_r2c`, unnormalized.  `shape`
    is the *logical real output* shape (FFTW convention)."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="c2r",
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_dft_c2r_1d(n: int, flags: int = ESTIMATE, dtype="float32",
                    device=None) -> Plan:
    return plan_dft_c2r((n,), (0,), flags, dtype, device)


def plan_dft_c2r_2d(n0: int, n1: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_c2r((n0, n1), (0, 1), flags, dtype, device)


def plan_dft_c2r_3d(n0: int, n1: int, n2: int, flags: int = ESTIMATE,
                    dtype="float32", device=None) -> Plan:
    return plan_dft_c2r((n0, n1, n2), (0, 1, 2), flags, dtype, device)


def plan_r2r(shape: Sequence[int], kinds, axes=None, flags: int = ESTIMATE,
             dtype="float32", device=None) -> Plan:
    """Real-to-real plan over `axes` of real tensors of `shape`, one kind
    per axis (or one kind for all of them): a :class:`Kind`, its name or
    its fftw3.h integer.  Unnormalized, like FFTW's r2r."""
    shape = tuple(shape)
    axes = _axes_tuple(shape, axes)
    ks = tuple(K.kind_from_name(k)
               for k in (kinds if isinstance(kinds, (list, tuple))
                         else [kinds] * len(axes)))
    prob = Problem(shape=shape, axes=axes, kind="r2r", r2r_kinds=ks,
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags, device=device)


def plan_r2r_1d(n: int, kind: Union[Kind, str, int], flags: int = ESTIMATE,
                dtype="float32", device=None) -> Plan:
    return plan_r2r((n,), [kind], (0,), flags, dtype, device)


def plan_r2r_2d(n0: int, n1: int, kind0, kind1, flags: int = ESTIMATE,
                dtype="float32", device=None) -> Plan:
    return plan_r2r((n0, n1), [kind0, kind1], (0, 1), flags, dtype, device)


def plan_r2r_3d(n0: int, n1: int, n2: int, kind0, kind1, kind2,
                flags: int = ESTIMATE, dtype="float32", device=None) -> Plan:
    return plan_r2r((n0, n1, n2), [kind0, kind1, kind2], (0, 1, 2), flags,
                    dtype, device)


def execute(plan: Plan, x) -> torch.Tensor:
    """fftw_execute analog (new-array execute: tensors are arguments)."""
    return plan.execute(x)


def flops(plan: Plan) -> Tuple[float, float, float]:
    return plan.flops()


def cost(plan: Plan) -> float:
    return plan.cost()


def print_plan(plan: Plan) -> None:
    plan.print_plan()


def fprint_plan(plan: Plan, file) -> None:
    """fftw_fprint_plan analog: write the plan tree to a file object."""
    print(repr(plan), file=file)


def sprint_plan(plan: Plan) -> str:
    return repr(plan)


def set_timelimit(t: Optional[float]) -> None:
    """Bound MEASURE-mode planning time in seconds (fftw_set_timelimit)."""
    planner_mod.the_planner.timelimit = None if t is None or t < 0 else t


def export_wisdom_to_string() -> str:
    return planner_mod.the_planner.export_wisdom()


def import_wisdom_from_string(s: str) -> bool:
    return planner_mod.the_planner.import_wisdom(s)


def import_reference_wisdom(s: str, device=None) -> bool:
    """Carry a ``fftw3_tpu`` wisdom export into the global planner (see
    :meth:`Planner.import_reference_wisdom`)."""
    return planner_mod.the_planner.import_reference_wisdom(s, device)


def export_wisdom_to_filename(path: str) -> bool:
    try:
        with open(path, "w") as f:
            f.write(export_wisdom_to_string())
        return True
    except OSError:
        return False


def import_wisdom_from_filename(path: str) -> bool:
    try:
        with open(path) as f:
            return import_wisdom_from_string(f.read())
    except OSError:
        return False


def export_wisdom_to_file(f) -> bool:
    """fftw_export_wisdom_to_file analog: write wisdom to an open file
    object (the FILE* form; the _to_filename variant opens a path)."""
    try:
        f.write(export_wisdom_to_string())
        return True
    except (OSError, AttributeError):
        return False


def import_wisdom_from_file(f) -> bool:
    """fftw_import_wisdom_from_file analog: read wisdom from an open file
    object."""
    try:
        return import_wisdom_from_string(f.read())
    except (OSError, AttributeError):
        return False


def export_wisdom(write_char) -> None:
    """fftw_export_wisdom analog (the write-callback form): calls
    ``write_char`` once with the whole serialized wisdom."""
    write_char(export_wisdom_to_string())


def import_wisdom(read_char) -> bool:
    """fftw_import_wisdom analog (the read-callback form): ``read_char``
    returns the serialized wisdom string."""
    return import_wisdom_from_string(read_char())


#: where :func:`import_system_wisdom` looks, unless the environment
#: variable names another file
SYSTEM_WISDOM_ENV = "FFTW3_TPU_TORCH_SYSTEM_WISDOM"
SYSTEM_WISDOM_PATH = "/etc/fftw3_tpu_torch/wisdom.json"


def import_system_wisdom() -> bool:
    """fftw_import_system_wisdom analog: load this package's wisdom format
    from ``$FFTW3_TPU_TORCH_SYSTEM_WISDOM`` or
    ``/etc/fftw3_tpu_torch/wisdom.json``."""
    return import_wisdom_from_filename(
        os.environ.get(SYSTEM_WISDOM_ENV, SYSTEM_WISDOM_PATH))


def estimate_cost(shape: Sequence[int], axes=None, kind: str = "c2c",
                  dtype="complex64", r2r_kinds: Sequence = (),
                  device=None) -> float:
    """fftw_estimate_cost analog: the planner's ESTIMATE-mode cost (seconds
    per full transform, heuristic) without building the plan's closures,
    for plans on `device`."""
    shape = tuple(shape)
    axes = _axes_tuple(shape, axes)
    pl = planner_mod.the_planner
    rd = np.dtype(_rdtype_of(dtype))
    pat = K.PATIENCE_ESTIMATE
    total = 0.0
    for i, a in enumerate(axes):
        n = shape[a]
        if kind == "r2r":
            k = K.kind_from_name(r2r_kinds[i] if i < len(r2r_kinds)
                                 else Kind.R2HC)
            total += pl._cost("r2r", pl.plan_r2r(k, n, rd, pat,
                                                 device=device))
        elif kind in ("r2c", "c2r") and a == axes[-1]:
            plan_real = pl.plan_r2c if kind == "r2c" else pl.plan_c2r
            total += pl._cost(kind, plan_real(n, rd, pat, device=device))
        else:
            total += pl._cost("c2c", pl.plan_c2c(n, rd, pat, device=device))
    batch = 1
    for i, s in enumerate(shape):
        if i not in axes:
            batch *= s
    return total * batch


def forget_wisdom() -> None:
    planner_mod.the_planner.forget_wisdom()
    _cached_plan.cache_clear()


def cleanup() -> None:
    """fftw_cleanup analog: drop all cached plans and wisdom."""
    forget_wisdom()


# ---------------------------------------------------------------------------
# numpy-style functional API (plan-cached)
# ---------------------------------------------------------------------------

#: planning patience of the numpy/scipy functional surface (ESTIMATE, as
#: FFTW's functional users get by default)
_functional_flags: int = ESTIMATE


def set_functional_flags(flags: int) -> None:
    """Set the planner flags used by the numpy-style functional API (fft,
    rfftn, dct, ...).  Cached plans are dropped so they re-plan at the new
    patience."""
    global _functional_flags
    _functional_flags = int(flags)
    _cached_plan.cache_clear()


def get_functional_flags() -> int:
    return _functional_flags


def _device_key(device: torch.device) -> str:
    """One cache key per card: ``cuda`` and ``cuda:<current>`` are one
    device."""
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() \
            if torch.cuda.is_available() else 0
        device = torch.device("cuda", index)
    return str(device)


@lru_cache(maxsize=512)
def _cached_plan(kind: str, shape: Tuple[int, ...], axes: Tuple[int, ...],
                 sign: int, dtype_name: str, device: str,
                 r2r_kinds: Tuple[str, ...] = (),
                 flags: Optional[int] = None) -> Plan:
    if flags is None:
        flags = _functional_flags
    if kind == "c2c":
        return plan_dft(shape, axes, sign, flags, dtype_name, device)
    if kind == "r2c":
        return plan_dft_r2c(shape, axes, flags, dtype_name, device)
    if kind == "c2r":
        return plan_dft_c2r(shape, axes, flags, dtype_name, device)
    return plan_r2r(shape, list(r2r_kinds), axes, flags, dtype_name, device)


def _plan_for(kind: str, x: torch.Tensor, axes, sign: int, dtype_name: str,
              r2r_kinds: Tuple[str, ...] = (), shape=None) -> Plan:
    axes = tuple(a % x.dim() for a in axes)
    return _cached_plan(kind, tuple(x.shape if shape is None else shape),
                        axes, sign, dtype_name, _device_key(x.device),
                        r2r_kinds)


def _norm_scale(norm: Optional[str], n: int, forward: bool) -> float:
    if norm in (None, "backward"):
        return 1.0 if forward else 1.0 / n
    if norm == "ortho":
        return 1.0 / np.sqrt(n)
    if norm == "forward":
        return 1.0 / n if forward else 1.0
    raise ValueError(f"bad norm {norm!r}")


def _tensor(x) -> torch.Tensor:
    """A torch tensor stays where it is; anything else becomes a tensor on
    ``config.device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.ascontiguousarray(x), device=config.device)


def _as_complex(x) -> torch.Tensor:
    x = _tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex128 if x.dtype == torch.float64
                 else torch.complex64)
    return x


def _as_real(x) -> torch.Tensor:
    x = _tensor(x)
    if x.is_complex():
        raise TypeError("this transform requires real input")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    return x


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).replace("torch.", "")


def _scaled(y: torch.Tensor, s: float) -> torch.Tensor:
    return y if s == 1.0 else y * s


def _c2c(x, axes, sign, norm, forward):
    x = _as_complex(x)
    axes = _axes_tuple(x.shape, axes)
    y = _plan_for("c2c", x, axes, sign, _dtype_name(x)).apply(x)
    n = int(np.prod([x.shape[a] for a in axes]))
    return _scaled(y, _norm_scale(norm, n, forward))


def fft(x, n=None, axis=-1, norm=None):
    return _c2c(_fit_length(_tensor(x), n, axis), (axis,), FORWARD, norm,
                True)


def ifft(x, n=None, axis=-1, norm=None):
    return _c2c(_fit_length(_tensor(x), n, axis), (axis,), BACKWARD, norm,
                False)


def _fit_shape(x, s, axes):
    """numpy's `s=` semantics: crop/zero-pad each axis to s[i]."""
    if s is None:
        return x, axes
    if axes is None:
        axes = tuple(range(x.dim() - len(s), x.dim()))
    axes = _axes_tuple(x.shape, axes)
    for a, n in zip(axes, s):
        x = _fit_length(x, n, a)
    return x, axes


def fft2(x, s=None, axes=(-2, -1), norm=None):
    x, axes = _fit_shape(_tensor(x), s, axes)
    return _c2c(x, axes, FORWARD, norm, True)


def ifft2(x, s=None, axes=(-2, -1), norm=None):
    x, axes = _fit_shape(_tensor(x), s, axes)
    return _c2c(x, axes, BACKWARD, norm, False)


def fftn(x, s=None, axes=None, norm=None):
    x, axes = _fit_shape(_tensor(x), s, axes)
    return _c2c(x, axes, FORWARD, norm, True)


def ifftn(x, s=None, axes=None, norm=None):
    x, axes = _fit_shape(_tensor(x), s, axes)
    return _c2c(x, axes, BACKWARD, norm, False)


def rfft(x, n=None, axis=-1, norm=None):
    return rfftn(_fit_length(_tensor(x), n, axis), axes=(axis,), norm=norm)


def rfftn(x, s=None, axes=None, norm=None):
    x, axes = _fit_shape(_tensor(x), s, axes)
    x = _as_real(x)
    axes = _axes_tuple(x.shape, axes)
    y = _plan_for("r2c", x, axes, FORWARD, _dtype_name(x)).apply(x)
    n = int(np.prod([x.shape[a] for a in axes]))
    return _scaled(y, _norm_scale(norm, n, True))


def rfft2(x, s=None, axes=(-2, -1), norm=None):
    return rfftn(x, s, axes, norm)


def irfft(x, n=None, axis=-1, norm=None):
    return irfftn(x, s=None if n is None else (n,), axes=(axis,), norm=norm)


def irfftn(x, s=None, axes=None, norm=None):
    x = _as_complex(x)
    axes = _axes_tuple(x.shape, axes)
    if s is None:
        s = [x.shape[a] for a in axes]
        s[-1] = 2 * (x.shape[axes[-1]] - 1)
    shape = list(x.shape)
    for a, dim in zip(axes, s):
        shape[a] = dim
    rdt = "float64" if x.dtype == torch.complex128 else "float32"
    y = _plan_for("c2r", x, axes, BACKWARD, rdt, shape=shape).apply(x)
    return _scaled(y, _norm_scale(norm, int(np.prod(s)), False))


def irfft2(x, s=None, axes=(-2, -1), norm=None):
    return irfftn(x, s, axes, norm)


_DCT_KINDS = {1: Kind.REDFT00, 2: Kind.REDFT10, 3: Kind.REDFT01,
              4: Kind.REDFT11}
_DST_KINDS = {1: Kind.RODFT00, 2: Kind.RODFT10, 3: Kind.RODFT01,
              4: Kind.RODFT11}
_IDCT_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def _r2r_1axis(x, kind: Kind, axis):
    x = _as_real(x)
    return _plan_for("r2r", x, (axis,), FORWARD, _dtype_name(x),
                     (kind.value,)).apply(x)


def dct(x, type: int = 2, axis: int = -1, norm=None):
    """scipy-compatible DCT (norm=None == FFTW unnormalized convention;
    "ortho"/"forward" delegate to the scipy-norm layer)."""
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.dct(x, type, None, axis, norm)
    return _r2r_1axis(x, _DCT_KINDS[type], axis)


def idct(x, type: int = 2, axis: int = -1, norm=None):
    """With norm=None, the unnormalized inverse: idct(dct(x)) == 2*n*x
    (FFTW semantics); "ortho" is the scipy orthonormal inverse."""
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.idct(x, type, None, axis, norm)
    return dct(x, _IDCT_TYPE[type], axis, None)


def dst(x, type: int = 2, axis: int = -1, norm=None):
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.dst(x, type, None, axis, norm)
    return _r2r_1axis(x, _DST_KINDS[type], axis)


def idst(x, type: int = 2, axis: int = -1, norm=None):
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.idst(x, type, None, axis, norm)
    return dst(x, _IDCT_TYPE[type], axis, None)


def dht(x, axis: int = -1):
    """Discrete Hartley transform (FFTW_DHT), self-inverse up to n."""
    return _r2r_1axis(x, Kind.DHT, axis)


def _fit_length(x: torch.Tensor, n, axis) -> torch.Tensor:
    """Crop or zero-pad `axis` of `x` to n (a new zero tensor and one copy,
    for every dtype and device)."""
    if n is None:
        return x
    axis = axis % x.dim()
    cur = x.shape[axis]
    if n == cur:
        return x
    if n < cur:
        return x.narrow(axis, 0, n)
    shape = list(x.shape)
    shape[axis] = n
    out = x.new_zeros(shape)
    out.narrow(axis, 0, cur).copy_(x)
    return out


# re-exported helpers (torch.fft's, as the reference takes jnp.fft's)
fftfreq = torch.fft.fftfreq
rfftfreq = torch.fft.rfftfreq
fftshift = torch.fft.fftshift
ifftshift = torch.fft.ifftshift


# ---------------------------------------------------------------------------
# source-compatibility shims (fftw3.h odds and ends)
# ---------------------------------------------------------------------------

#: fftw_version / fftw_cc / fftw_codelet_optim analogs (fftw3.h exports
#: these as global strings; tools print them)
version = ("fftw3_tpu_torch-0.1.0 (FFTW-3.3.8 capability surface, "
           "PyTorch on CUDA)")
cc = "nvcc (sm_90a CUDA C++ kernels) + PyTorch"
codelet_optim = ("split-complex Stockham, register butterfly levels, "
                 "one kernel per axis pass (NVIDIA Hopper)")


def alloc_real(n: int, dtype="float32", device=None) -> torch.Tensor:
    """fftw_alloc_real analog: a zeroed real tensor on `device` (default
    ``config.device``).  The caching allocator aligns every block; provided
    for source compatibility."""
    return torch.zeros(int(n), dtype=_torch_dtype(dtype),
                       device=config.device if device is None else device)


def alloc_complex(n: int, dtype="complex64", device=None) -> torch.Tensor:
    """fftw_alloc_complex analog (see alloc_real)."""
    return torch.zeros(int(n), dtype=_torch_dtype(dtype),
                       device=config.device if device is None else device)


def malloc(n: int, device=None) -> torch.Tensor:
    """fftw_malloc analog: a zeroed byte tensor."""
    return torch.zeros(int(n), dtype=torch.uint8,
                       device=config.device if device is None else device)


def free(x) -> None:
    """fftw_free analog: a no-op — PyTorch's allocator owns every buffer.
    Accepts anything alloc_real/alloc_complex/malloc returned."""


def alignment_of(x) -> int:
    """fftw_alignment_of analog: always 0 — plans never specialize on
    alignment (every kernel takes any tensor of the plan's dtype)."""
    return 0


def destroy_plan(plan) -> None:
    """fftw_destroy_plan analog: a no-op — plans are garbage-collected;
    cached wisdom is owned by the planner, not the plan (use
    forget_wisdom/cleanup)."""


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)
