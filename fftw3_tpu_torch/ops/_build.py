"""Build and bind the CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links the objects into one
shared library with a plain C interface under ``fftw3_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash over every file in ``csrc/``, so
an edited source or header is rebuilt and an unchanged tree is loaded as it
is.  The library is bound with ``ctypes``: pointers and the stream as
``c_void_p``, ints as ``c_int``, 64-bit extents as ``c_longlong``, a
level plan as a pointer to ``c_int``.  ``nvcc``
is found through ``CUDA_HOME``, else through
``torch.utils.cpp_extension.CUDA_HOME``.  A failed build raises with nvcc's
own error output.  Each build keeps what ``-Xptxas -v`` said of every
kernel beside the library (:func:`register_report`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .. import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
#: K7's entry points (csrc/df32_c2c.cu)
_K7 = (*(f"df32_c2c_f{f}" for f in range(4)),
       *(f"df32_ablate{a}" for a in range(4)))
#: C signature (argument types) of every bound entry point; each returns
#: the CUDA error code as an int
SIGNATURES = {
    # xr xi yr yi tab, plan, rows n rpb, ptw, ptw_p store_p layout grid
    # smem, stream
    "stockham_c2c_launch": [_P] * 5 + [_IP] + [_I] * 3 + [_P] + [_I] * 5
    + [_P],
    "stockham_c2c_occupancy": [_I, ctypes.POINTER(_I)],
    # K1's wide form: the same arguments
    "stockham_c2c_wide_launch": [_P] * 5 + [_IP] + [_I] * 3 + [_P]
    + [_I] * 5 + [_P],
    "stockham_c2c_wide_occupancy": [_I, ctypes.POINTER(_I)],
    # K1 in place (E10's donate, timing only): xr xi tab, plan, rows n rpb
    # grid smem, stream
    "stockham_c2c_inplace_launch": [_P] * 3 + [_IP] + [_I] * 5 + [_P],
    "stockham_c2c_inplace_occupancy": [_I, ctypes.POINTER(_I)],
    # xr xi yr yi tab, plan, pre n, L, tl gp layout grid smem, stream
    "inner_c2c_launch": [_P] * 5 + [_IP] + [_I] * 2 + [_L] + [_I] * 5
    + [_P],
    "inner_c2c_occupancy": [_I, ctypes.POINTER(_I)],
    # xr xi yr yi tab, plan2 plan1, pre n1 n2 rows tc layout ring fixed
    # grid smem, stream; smem ring fixed
    "c2c_2d_launch": [_P] * 5 + [_IP] * 2 + [_I] * 10 + [_P],
    "c2c_2d_occupancy": [_I, _I, _I, ctypes.POINTER(_I)],
    # x yr yi tab, plan, rows n rpb grid smem, stream
    "r2c_launch": [_P] * 4 + [_IP] + [_I] * 5 + [_P],
    "r2c_occupancy": [_I, ctypes.POINTER(_I)],
    # xr xi y tab, plan, rows n rpb grid smem, stream
    "c2r_launch": [_P] * 4 + [_IP] + [_I] * 5 + [_P],
    "c2r_occupancy": [_I, ctypes.POINTER(_I)],
    # x yr yi tab, plan, pre n, L, tl grid smem, stream
    "r2c_inner_launch": [_P] * 4 + [_IP] + [_I] * 2 + [_L] + [_I] * 3
    + [_P],
    "r2c_inner_occupancy": [_I, ctypes.POINTER(_I)],
    # K8: x y tab, plan, rows n rpb dir fixed grid smem, stream
    "redft_launch": [_P] * 3 + [_IP] + [_I] * 7 + [_P],
    "redft_occupancy": [_I, ctypes.POINTER(_I)],
    # K7 per pass-kind family, df32_c2c_f<family>, and its timing-only
    # arms, df32_ablate<arm>: xr xi yr yi tab itab, plan, rows n rpb sign
    # grid smem, stream
    **{f"{k}_launch": [_P] * 6 + [_IP] + [_I] * 6 + [_P] for k in _K7},
    **{f"{k}_occupancy": [_I, ctypes.POINTER(_I)] for k in _K7},
    # E5 (ablate_stage.cu), timing only: xr xi yr yi tab, tab_len rows n
    # nstages p0 p1 arm grid smem, stream; xr xi yr yi tab, plan, rows n rpb
    # arm grid smem, stream
    "ablate_dense_launch": [_P] * 5 + [_I] * 9 + [_P],
    "ablate_dense_occupancy": [_I, ctypes.POINTER(_I)],
    "ablate_bfly_launch": [_P] * 5 + [_IP] + [_I] * 6 + [_P],
    "ablate_bfly_occupancy": [_I, ctypes.POINTER(_I)],
    # E8 (copy_floor.cu), timing only: xr xi yr yi, pre n, L, tl gp grid
    # smem, stream; xr xi yr yi, rows n rpb grid smem, stream
    "copy_inner_launch": [_P] * 4 + [_I] * 2 + [_L] + [_I] * 4 + [_P],
    "copy_inner_occupancy": [_I, ctypes.POINTER(_I)],
    "copy_rows_launch": [_P] * 4 + [_I] * 5 + [_P],
    "copy_rows_occupancy": [_I, ctypes.POINTER(_I)],
    # P1 (probe.cu), the toolchain canary: g x y, n, stream
    "probe_matmul_launch": [_P] * 3 + [_I, _P],
    # E1 (unaligned.cu), timing only: x y, rows n rpb grid smem, stream;
    # x y, rows n grid smem, stream
    "unaligned_copy_launch": [_P] * 2 + [_I] * 5 + [_P],
    "unaligned_copy_occupancy": [_I, ctypes.POINTER(_I)],
    "unaligned_trans_launch": [_P] * 2 + [_I] * 4 + [_P],
    "unaligned_trans_occupancy": [_I, ctypes.POINTER(_I)],
    # E2/E3 (stage4096.cu), timing only: xr xi yr yi consts twr twi, rows p
    # arm rpb grid smem, stream; arm p rpb smem
    "stage4096_launch": [_P] * 7 + [_I] * 6 + [_P],
    "stage4096_occupancy": [_I] * 4 + [ctypes.POINTER(_I)],
    # E7 (swap.cu), timing only: xr xi yr yi, batch p q grid smem, stream
    "swap_launch": [_P] * 4 + [_I] * 5 + [_P],
    "swap_occupancy": [_I, ctypes.POINTER(_I)],
    # E4, E6, E9-E12 (k1_mma_*.cu), timing only: variant, xr xi yr yi c1
    # c2 tw, rows rpb reps host_split grid smem, stream; variant smem
    **{f"k1_mma_{src}_launch": [_I] + [_P] * 7 + [_I] * 6 + [_P]
       for src in ("karatsuba", "stacked64", "stacked")},
    **{f"k1_mma_{src}_occupancy": [_I, _I, ctypes.POINTER(_I)]
       for src in ("karatsuba", "stacked64", "stacked")},
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build of this process took (0.0 when it loaded a
#: library built before)
build_seconds: float = 0.0


def sources() -> List[Path]:
    """The kernel sources, one object each."""
    return sorted(CSRC.glob("*.cu"))


def digest() -> str:
    """Hash over every file of ``csrc/`` (sources and headers)."""
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.is_file():
            h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils import cpp_extension
        home = cpp_extension.CUDA_HOME
    if not home:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to the "
                           "directory that holds bin/nvcc")
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _check(res: subprocess.CompletedProcess, cmd: List[str]) -> None:
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr}{res.stdout}")


def _build(out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    objs, procs, info = [], [], []
    try:
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                   str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(str(obj))
        for cmd, proc in procs:
            stdout, stderr = proc.communicate()
            _check(subprocess.CompletedProcess(cmd, proc.returncode, stdout,
                                               stderr), cmd)
            info.append(stderr)
        out.with_suffix(".ptxas.txt").write_text("".join(info))
        tmp = work / "lib.so"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
        _check(subprocess.run(cmd, capture_output=True, text=True), cmd)
        os.replace(tmp, out)           # atomic: a reader never sees a partial
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def _library_path() -> Path:
    return BUILD_DIR / f"libfftw3_tpu_torch_{digest()}.so"


def register_report() -> Dict[str, Tuple[int, int, int]]:
    """What ptxas said of each kernel of the current build (``-Xptxas
    -v``): {kernel: (registers, spill-store bytes, stack-frame bytes)},
    the kernel named by its identifier and template arguments.  Empty when
    the library was built before the report was kept."""
    path = _library_path().with_suffix(".ptxas.txt")
    if not path.exists():
        return {}
    report, name, frame = {}, None, (0, 0)
    for line in path.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            frame = (int(m.group(2)), int(m.group(1)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "kernel" in name:
            report[name] = (int(m.group(1)),) + frame
            name = None
    return report


def _kernel_name(mangled: str) -> str:
    """``c2c_2d_kernel`` or ``stockham_c2c_kernel<0,1,1>`` from an Itanium
    mangled name (identifiers are length-prefixed; template arguments
    ``Li<int>E`` and ``Lb<0|1>E``)."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        k = int(m.group(1))
        end = m.start() + len(m.group(1))
        ident = mangled[end:end + k]
        if ident.endswith("_kernel") and len(ident) == k:
            rest = mangled[end + k:]
            if rest.startswith("I"):
                args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 2])
                return f"{ident}<{','.join(args)}>"
            return ident
    return mangled


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if ``csrc/`` changed.  The
    first call's time, a build's excluded, adds to the set-up counter
    ``setup.library_s`` (``trace.py``)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0, built = time.perf_counter(), 0.0
        out = _library_path()
        if not out.exists():
            _build(out)
            built = build_seconds
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        trace.add("setup.library_s", time.perf_counter() - t0 - built)
        return lib
