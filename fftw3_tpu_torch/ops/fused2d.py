"""c2c over both trailing axes in one launch (K3) — the port of the fused
2-D form of ``fftw3_tpu/ops/pallas_stockham.py`` (``_kernel_2d``,
``_make_call_2d``, ``build_pallas_c2c_split_2d``).

Split f32 planes (pre, n1, n2) get the n2 schedule along the rows and then
the n1 schedule along the columns.  Multi-axis plans send the trailing axis
pair here when ``stockham.applicable_2d`` admits it and both axes' planner
descriptors are ``pallas``.

* :func:`c2c_2d_torch`, the plain twin: the last-axis twin over the rows,
  then the axis -2 twin over the columns.
* :func:`c2c_2d_cuda`, the wrapper of ``csrc/c2c_2d.cu``.  A plane does not
  fit a block's shared memory, so one thread-block cluster owns a plane: a
  row pass to the output, a barrier across the cluster, then a column pass
  in place, with the plane in L2 between the two.  Both passes run the
  stages as K1 does (register butterflies for a 2-3-5-smooth radix, the
  dense sum otherwise; ``stockham.level_plan`` with tl = 1 for the rows and
  tl = tc for the columns).  It also writes one interleaved complex64
  output in place of the two output planes (a plan's last pass asked for
  the complex output); its input stays in planes.  Where it fits
  (:func:`ring_fits`: no dense stage, 16-byte pieces and alignment, two
  tile buffers within its shared memory) a block walks its tiles on a
  ring of two buffers, the next tile copied in while the levels run on
  the current one; elsewhere every tile in turn.  On 512 x 512 planes
  with ESTIMATE's [32, 16] both ways (:func:`fixed_fits`) either walk
  runs the levels compiled into the kernel, every radix and geometry a
  constant; every other schedule reads its level plans at run time.
  Every form gives the same output bit for bit.

The reference's ``tile_b``/``tile_g`` plane grouping is TPU tuning and is
ignored; so is its ``_inner_radices`` cap.  The kernel runs the
descriptors' own schedules.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from . import inner, passes
from . import stockham as S

#: points of a row chunk or a column tile (``kTilePoints`` in
#: csrc/c2c_2d.cu): one split buffer of 64 KB and its pads
TILE_POINTS = 8192
#: blocks per plane: one thread-block cluster of the portable maximum size
#: (``kCluster`` in csrc/c2c_2d.cu)
CLUSTER = 8

#: dynamic shared memory the kernel is allowed (``kMaxSmem`` in
#: csrc/c2c_2d.cu)
MAX_SMEM = 180224

#: the level plans compiled into the kernel (``FixedRows``, ``FixedCols``
#: in csrc/c2c_2d.cu): ``stockham.level_plan(512, (32, 16), tl)`` of the
#: row pass (tl = 1) and of the column pass (tl = 16, the tiles of 512 x
#: 512).  Written out, not computed: when the host's plans change, they no
#: longer equal these and the kernel's run-time form runs them.
FIXED_PLANS = (
    (3, 1, 632, 1120, 8, 8, 1, 512, 64, 0, 512, 1, 4, 4, 8, 64, 64, 0, 512,
     8, 16, 16, 32, 16, 1088, 0, 16, 0),
    (3, 1, 9212, 1120, 8, 8, 1, 512, 64, 0, 512, 4, 4, 4, 8, 64, 64, 0, 512,
     0, 16, 16, 32, 16, 1088, 0, 16, 0))

#: launches of the CUDA kernel, counted by :func:`c2c_2d_cuda`, those of
#: them that took the ring, and those that ran the levels compiled in
launches = 0
ring_launches = 0
fixed_launches = 0


def tiles(n1: int, n2: int) -> Tuple[int, int]:
    """(rows per row chunk, columns per column tile, a power of two), each
    tile at most TILE_POINTS points."""
    rows = max(1, min(n1, TILE_POINTS // n2))
    tc = 1
    while 2 * tc <= n2 and 2 * tc * n1 <= TILE_POINTS:
        tc *= 2
    return rows, tc


def c2c_2d_torch(xr: torch.Tensor, xi: torch.Tensor, rad1: Sequence[int],
                 rad2: Sequence[int], sign: int, vpu=None):
    """Plain PyTorch twin of the kernel: unnormalized c2c over both
    trailing axes of split f32 planes (..., n1, n2), n2 first."""
    yr, yi = S.stockham_c2c_torch(xr, xi, rad2, sign, vpu)
    return inner.inner_c2c_torch(yr, yi, rad1, sign, vpu)


@lru_cache(maxsize=None)
def device_table_2d(n1: int, rad1: Tuple[int, ...], n2: int,
                    rad2: Tuple[int, ...], sign: int,
                    device: torch.device) -> torch.Tensor:
    """The n2 schedule's root tables, then the n1 schedule's, as one f32
    tensor on `device`, made once."""
    return torch.from_numpy(np.concatenate([
        S.kernel_table(n2, rad2, sign),
        S.kernel_table(n1, rad1, sign)])).to(device)


def smem_2d(plan2: Sequence[int], plan1: Sequence[int], rows: int,
            ring: bool = False) -> int:
    """Shared-memory bytes of K3 (``smem_bytes`` in csrc/c2c_2d.cu): both
    root tables, then one buffer (two with a dense stage, and on the ring)
    of two planes that hold a row chunk at the row plan's stride or a
    column tile."""
    plane = -(-max(rows * plan2[2], plan1[2]) // 4) * 4
    tabs = -(-(plan2[3] + plan1[3]) // 4) * 4
    nbuf = 2 if ring else max(plan2[1], plan1[1])
    return 4 * (tabs + 2 * nbuf * plane)


def ring_fits(plan2: Sequence[int], plan1: Sequence[int], rows: int,
              n2: int, tc: int, pointers: Sequence[int]) -> bool:
    """Does K3 walk its tiles on the ring?  Its second buffer is the ring's,
    so neither plan may have a dense stage; a row chunk is copied in whole
    16-byte pieces (n2 a multiple of 4) and a column tile too (tc one), from
    and to tensors whose addresses, `pointers`, are 16-byte aligned; both
    buffers and the tables fit ``MAX_SMEM``."""
    return (plan2[1] == 1 and plan1[1] == 1 and n2 % 4 == 0 and tc % 4 == 0
            and all(p % 16 == 0 for p in pointers)
            and smem_2d(plan2, plan1, rows, ring=True) <= MAX_SMEM)


def fixed_fits(plan2: Sequence[int], plan1: Sequence[int]) -> bool:
    """Does K3 run the levels compiled into it?  Exactly when the row and
    column level plans are :data:`FIXED_PLANS`."""
    return (tuple(plan2), tuple(plan1)) == FIXED_PLANS


#: (device index, shared-memory bytes, ring, fixed) -> clusters resident
#: on the card
_clusters: Dict[Tuple[int, int, bool, bool], int] = {}


def _resident_clusters(lib, device: torch.device, smem: int, ring: bool,
                       fixed: bool) -> int:
    """How many clusters of CLUSTER blocks of `smem` bytes of the form
    (`ring`, `fixed`) the card runs at once; the first call per key also
    allows the kernel its shared memory.  The caller has made `device`
    current."""
    key = (device.index, smem, ring, fixed)
    got = _clusters.get(key)
    if got is None:
        n = ctypes.c_int(0)
        rc = lib.c2c_2d_occupancy(smem, int(ring), int(fixed),
                                  ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"c2c_2d occupancy query failed: CUDA error "
                               f"{rc}, {n.value} clusters of {CLUSTER} "
                               f"blocks at smem={smem} bytes")
        got = _clusters[key] = n.value
    return got


def c2c_2d_cuda(xr: torch.Tensor, xi: torch.Tensor, rad1: Sequence[int],
                rad2: Sequence[int], table: torch.Tensor,
                complex_out: bool = False):
    """Launch the CUDA kernel on split (pre, n1, n2) f32 planes on one
    card.  ``table`` is ``device_table_2d(n1, rad1, n2, rad2, sign,
    device)``.  Returns new (yr, yi), or with `complex_out` one new
    complex64 tensor written interleaved; raises on anything the kernel
    does not take, and when the launch fails."""
    global launches, ring_launches, fixed_launches
    if xi is None:
        raise ValueError("c2c_2d_cuda takes split input planes")
    passes.check_planes("c2c_2d_cuda", xr, xi, table, 3)
    pre, n1, n2 = xr.shape
    rad1 = [int(r) for r in rad1]
    rad2 = [int(r) for r in rad2]
    if not (S.radices_ok(n1, rad1) and S.radices_ok(n2, rad2)):
        raise ValueError(f"kernel schedules {rad1}, {rad2} do not fit "
                         f"({n1}, {n2})")
    len2, len1 = S.table_len(n2, rad2), S.table_len(n1, rad1)
    if table.numel() != len2 + len1:
        raise ValueError(f"root tables of {table.numel()} floats do not "
                         f"match schedules {rad1}, {rad2}")
    if pre >= 2 ** 31:
        raise ValueError(f"{pre} planes exceed the kernel's int count")
    y = passes.new_output(xr.shape, xr.device, complex_out)
    if pre == 0:
        return y[0] if complex_out else y
    rows, tc = tiles(n1, n2)
    plan2 = S.level_plan(n2, tuple(rad2), 1)
    plan1 = S.level_plan(n1, tuple(rad1), tc)
    ptrs = (xr.data_ptr(), xi.data_ptr(), *passes.pointers(*y))
    ring = ring_fits(plan2, plan1, rows, n2, tc,
                     [p for p in ptrs if p is not None])
    fixed = fixed_fits(plan2, plan1)
    smem = smem_2d(plan2, plan1, rows, ring)
    from . import _build
    lib = _build.library()
    with trace.span("fftw.launch.c2c_2d"), passes.device_guard(xr.device):
        grid = CLUSTER * min(pre, _resident_clusters(lib, xr.device, smem,
                                                     ring, fixed))
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = lib.c2c_2d_launch(
            *ptrs, table.data_ptr(), S.plan_array(plan2),
            S.plan_array(plan1), pre, n1, n2, rows, tc,
            passes.layout_of(xi, complex_out), int(ring), int(fixed), grid,
            smem, stream)
    if rc != 0:
        raise RuntimeError(f"c2c_2d kernel launch failed: CUDA error {rc} "
                           f"(pre={pre}, n1={n1}, n2={n2}, radices {rad1}, "
                           f"{rad2}, complex out {complex_out}, ring "
                           f"{ring}, fixed {fixed})")
    launches += 1
    if ring:
        ring_launches += 1
    if fixed:
        fixed_launches += 1
    return y[0] if complex_out else y


def build_pallas_c2c_split_2d(n1: int, n2: int, sign: int, rdtype,
                              desc1: Optional[Dict] = None,
                              desc2: Optional[Dict] = None,
                              device: Optional[torch.device] = None):
    """The pass (``ops/passes.py``) over both trailing axes of (..., n1,
    n2) in one kernel launch.  ``desc1``/``desc2`` are the per-axis planner
    descriptors; their ``radices`` and ``vpu`` pins are honoured (``vpu``
    by the twin only: on the card the radix picks the stage form).  K3
    writes the complex output itself; a complex input is split first."""
    desc1, desc2 = desc1 or {}, desc2 or {}
    rad1 = list(desc1.get("radices") or S.choose_radices(n1))
    rad2 = list(desc2.get("radices") or S.choose_radices(n2))
    if not (S.radices_ok(n1, rad1) and S.radices_ok(n2, rad2)):
        raise ValueError(f"schedules {rad1}, {rad2} do not fit ({n1}, {n2})")
    vpu = desc1.get("vpu", desc2.get("vpu"))
    key = (n1, tuple(rad1), n2, tuple(rad2))
    return passes.kernel_pass(
        (n1, n2), sign, rdtype, device,
        lambda s, dev: device_table_2d(*key, s, dev),
        lambda xr, xi, s: c2c_2d_torch(xr, xi, rad1, rad2, s, vpu),
        lambda xr, xi, table, cout: c2c_2d_cuda(xr, xi, rad1, rad2, table,
                                                complex_out=cout),
        writes=True)
