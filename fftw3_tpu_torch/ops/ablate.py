"""E5, the stage ablation of K1 — the port of the TPU measurement script
``experiments/ablate_stage.py`` (``make_variant``).

Timing-only launches of K1 at one schedule with one op class removed at a
time (``csrc/ablate_stage.cu``), for two stage forms: ``dense``, K1 as it
was first built (the dense p-term sum, one row per block), and ``bfly``, the
K1 of ``csrc/stockham_c2c.cu`` (register butterflies, several rows per
block).
The arms: ``full``; ``no twiddle`` (the inter-stage twiddle dropped);
``const roots`` (no root-table loads in the stage arithmetic); ``no stage``
(a copy through shared memory, the layout's floor).  Every arm but ``full``
computes wrong numbers on purpose.  No user path reaches this module;
``chip_smoke.py`` times the arms interleaved.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from . import passes
from . import stockham as S

ARMS = ("full", "no twiddle", "const roots", "no stage")
FORMS = ("dense", "bfly")

#: launches per (form, arm), counted by :func:`ablate_cuda`
launches: Dict[Tuple[str, str], int] = {}


def ablate_cuda(xr: torch.Tensor, xi: torch.Tensor, radices: Sequence[int],
                table: torch.Tensor, form: str, arm: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K1's `form` with `arm` on split (B, n) f32 planes on
    one card; ``table`` is ``stockham.device_table(n, radices, sign,
    device)``.  Returns new (yr, yi); raises on anything the kernel does not
    take, and when the launch fails."""
    passes.check_planes("ablate_cuda", xr, xi, table, 2)
    B, n = xr.shape
    radices = [int(r) for r in radices]
    if not S.radices_ok(n, radices) or form not in FORMS or arm not in ARMS:
        raise ValueError(f"no E5 arm {form!r}/{arm!r} for schedule "
                         f"{radices} at n={n}")
    if table.numel() != S.table_len(n, radices):
        raise ValueError(f"root table of {table.numel()} floats does not "
                         f"match schedule {radices}")
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    ptrs = (xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            table.data_ptr())
    a = ARMS.index(arm)
    what = f"E5 {form} {arm}, n={n}, radices={radices}, B={B}"
    if form == "dense":
        p1 = radices[1] if len(radices) == 2 else 1
        passes.launch("ablate_dense", xr.device,
                      4 * (table.numel() + 4 * n), B,
                      ptrs + (table.numel(), B, n, len(radices), radices[0],
                              p1, a), what)
    else:
        plan = S.level_plan(n, tuple(radices))
        rpb = S.rows_per_block(n)
        passes.launch("ablate_bfly", xr.device, S.plan_smem(plan, rpb),
                      -(-B // rpb), ptrs + (S.plan_array(plan), B, n, rpb, a),
                      what)
    launches[form, arm] = launches.get((form, arm), 0) + 1
    return yr, yi
