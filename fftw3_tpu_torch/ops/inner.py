"""c2c along axis -2 as one Stockham kernel (K2) — the port of the axis -2
form of ``fftw3_tpu/ops/pallas_stockham.py`` (``_kernel_inner``,
``_make_call_inner``, ``build_pallas_c2c_split_inner``).

Split f32 planes (pre, n, L) are transformed along n for each of the L
columns, with no transpose: multi-axis plans send every non-last axis here,
its trailing dims as the columns, and the four-step sends its p pass here.

* :func:`inner_c2c_torch`, the plain twin: the shared stage loop
  (``stockham.stages_torch``) with the L columns in the place of the
  reference's lane tile.
* :func:`inner_c2c_cuda`, the wrapper of ``csrc/inner_c2c.cu``.  A block
  holds an (n, tl) tile of tl consecutive columns (of gp planes when one
  tile holds a whole plane) in one shared-memory buffer through every
  stage, and runs the stages as K1 and K3 do: register butterfly levels for
  a 2-3-5-smooth radix, the dense sum otherwise, on
  ``stockham.level_plan(n, radices, tl)``.  The edge tile of an L that is
  not a multiple of tl is masked, nothing is padded.  It also reads one
  interleaved complex64 tensor in place of the two input planes (a
  plan's first pass on a complex input), and writes one in place of the
  two output planes (a plan's last pass asked for the complex output, as
  a multi-axis r2c's on its half spectrum), in any of the four pairings.

The reference's TPU tuning of this form is not carried over: the narrower
schedule of ``_inner_radices`` (``INNER_NP_MAX``), the ``INNER_AREA`` and
desc ``inner_area`` working-set budget, and ``pad_align``.  The kernel runs
the descriptor's own schedule; its results differ from the reference's by
rounding only.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from . import passes
from . import stockham as S

#: points of the kernel's group, gp * n * tl (``kTilePoints`` in
#: csrc/inner_c2c.cu): 512 threads of up to 16 points in a level, one split
#: buffer of 64 KB and its pads (the registers bound it, not shared memory)
TILE_POINTS = 8192

#: launches of the CUDA kernel, counted by :func:`inner_c2c_cuda`
launches = 0
#: those of them that wrote an interleaved complex64 output
cout_launches = 0


def tile_width(n: int, L: int) -> int:
    """Columns per block: the largest power of two with n*tl within
    TILE_POINTS and no wider than L needs."""
    tl = 1
    while tl < L and 2 * tl * n <= TILE_POINTS:
        tl *= 2
    return tl


def planes_per_group(n: int, L: int, pre: int) -> int:
    """Planes a block takes at once: more than one only when one tile
    holds a whole plane (tl >= L), then as many as TILE_POINTS holds."""
    tl = tile_width(n, L)
    if tl < L:
        return 1
    return max(1, min(pre, TILE_POINTS // (n * tl)))


def inner_c2c_torch(xr: torch.Tensor, xi: torch.Tensor,
                    radices: Sequence[int], sign: int, vpu=None):
    """Plain PyTorch twin of the kernel: unnormalized c2c along axis -2 of
    split f32 planes (..., n, L)."""
    n, L = xr.shape[-2:]
    if math.prod(radices) != n:
        raise ValueError(f"radices {list(radices)} do not multiply to {n}")
    shp = xr.shape
    st = torch.stack([xr.reshape(-1, n * L), xi.reshape(-1, n * L)], 1)
    st = S.stages_torch(st, n, L, radices, sign, vpu)
    return st[:, 0].reshape(shp), st[:, 1].reshape(shp)


def inner_c2c_cuda(xr: torch.Tensor, xi: Optional[torch.Tensor],
                   radices: Sequence[int], table: torch.Tensor,
                   complex_out: bool = False):
    """Launch the CUDA kernel on split (pre, n, L) f32 planes on one card,
    or with `xi` None on one (pre, n, L) complex64 tensor `xr` read
    interleaved.  ``table`` is ``stockham.device_table(n, radices, sign,
    device)``.  Returns new (yr, yi), or with `complex_out` one new
    complex64 tensor written interleaved; raises on anything the kernel
    does not take, and when the launch fails."""
    global launches, cout_launches
    passes.check_planes("inner_c2c_cuda", xr, xi, table, 3)
    pre, n, L = xr.shape
    radices = [int(r) for r in radices]
    if not S.radices_ok(n, radices):
        raise ValueError(f"kernel schedule {radices} does not fit n={n}")
    if table.numel() != S.table_len(n, radices):
        raise ValueError(f"root table of {table.numel()} floats does not "
                         f"match schedule {radices}")
    if pre >= 2 ** 31:
        raise ValueError(f"{pre} leading rows exceed the kernel's int count")
    y = passes.new_output(xr.shape, xr.device, complex_out)
    if pre == 0 or L == 0:
        return y[0] if complex_out else y
    tl = tile_width(n, L)
    gp = planes_per_group(n, L, pre)
    plan = S.level_plan(n, tuple(radices), tl)
    layout = passes.layout_of(xi, complex_out)
    passes.launch("inner_c2c", xr.device, S.plan_smem(plan, gp),
                  -(-pre // gp) * -(-L // tl),
                  (*passes.pointers(xr, xi), *passes.pointers(*y),
                   table.data_ptr(), S.plan_array(plan), pre, n, L, tl, gp,
                   layout),
             f"pre={pre}, n={n}, L={L}, radices={radices}, tl={tl}, gp={gp}, "
             f"layout {layout}")
    launches += 1
    cout_launches += complex_out
    return y[0] if complex_out else y


def build_pallas_c2c_split_inner(desc: Dict, sign: int, rdtype,
                                 device: Optional[torch.device] = None,
                                 columns: int = 1):
    """The pass (``ops/passes.py``) over axis -1 - `columns` of (..., n,
    *cols) tensors for a ``{"alg": "pallas", ...}`` descriptor, the
    `columns` trailing dims K2's L columns: its schedule and ``vpu`` pin
    (the twin's stage form; on the card the radix alone picks each stage's
    form, ``stockham.stage_form``).  K2 reads the complex input and writes
    the complex output itself."""
    n = desc["n"]
    radices = list(desc.get("radices") or S.choose_radices(n))
    if not S.radices_ok(n, radices):
        raise ValueError(f"pallas schedule {radices} does not fit n={n}")
    vpu = desc.get("vpu")
    key = (n, tuple(radices))

    def twin(xr, xi, s):
        cols = (-1, n, math.prod(xr.shape[xr.dim() - columns:]))
        return passes.shaped(inner_c2c_torch(xr.reshape(cols), xi.reshape(
            cols), radices, s, vpu), xr.shape)

    return passes.kernel_pass(
        (n,), sign, rdtype, device,
        lambda s, dev: S.device_table(*key, s, dev), twin,
        lambda xr, xi, table, cout: inner_c2c_cuda(xr, xi, radices, table,
                                                   complex_out=cout),
        columns=columns, reads=True, writes=True)
