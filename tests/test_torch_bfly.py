"""The register butterfly stage of K1-K6 (``csrc/stockham_bfly.cuh``) and
its host side in
``fftw3_tpu_torch.ops.stockham``.

* The port's ``_vpu_dft`` (the twin's butterfly form, the algorithm the
  kernel's register levels run) against the reference's ``_vpu_dft`` and
  numpy in float64, within 1e-5 (max-abs error over max-abs), at every
  radix the kernels now run as butterflies.
* The host's choice of form per stage and of register levels per radix,
  and the level plans the kernels read, against tables written out here.
* The plan executed in numpy on the kernel's own f32 root tables (read at
  the plan's offsets and strides) against ``numpy.fft``: the tables the
  butterfly levels read are checked against numpy's roots on the way.
* The pads of the shared-memory buffers: a warp's stores of one level land
  on 32 distinct banks on the main paths' plans.
* Every schedule the planner can hand K1 (its wide form's above MAX_N
  included), every plane the route gate sends to K3, every (n, tile width)
  K2 can be handed and every m-point schedule K4 and K6 can be handed has
  a plan the kernels' one run-time form runs, within their shared memory,
  threads and tiles.
* The kernels' level execution itself, emulated in numpy index for index
  (the plan's levels on the kernel's own f32 tables, the padded buffer,
  K2's tiles, plane groups, masked edge tile and column store, K4's groups
  of rows, its Z region and the untangle, K5's tiles with the packed first
  level read from the input rows, its Z region and the untangle along axis
  -2, K6's tangle into the level buffer and its float2 store of the real
  rows), against the reference's kernels in interpret mode.

Tests marked ``cuda`` run the kernels on a card (K1 over its case grid,
ragged batches, both signs, the dense fallback schedules, the four-step
options and the wide form; K2 and K4 on ragged batches, edge tiles, both
signs and the gradient; K5 on edge tiles, a dense stage and its path's
shape; K3 over the 2-D grid; E5's full arms; E8's arms) and skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu.ops import pallas_stockham as PS

from fftw3_tpu_torch.ops import ablate, copyfloor, fused2d, inner, matrices
from fftw3_tpu_torch.ops import real_stockham as RS
from fftw3_tpu_torch.ops import stockham as S

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _oracle(x, sign, axis=-1):
    n = x.shape[axis]
    if sign < 0:
        return np.fft.fft(x, axis=axis)
    return np.fft.ifft(x, axis=axis) * n


@pytest.mark.parametrize("m", [8, 16, 20, 32, 50, 64, 128, 256])
@pytest.mark.parametrize("sign", [-1, +1])
def test_vpu_dft_matches_reference_and_numpy(m, sign):
    rng = np.random.default_rng(m)
    R = 3
    xr = rng.standard_normal((m, R)).astype(np.float32)
    xi = rng.standard_normal((m, R)).astype(np.float32)
    rr, ri = PS._vpu_dft(jnp.asarray(xr), jnp.asarray(xi), m, sign)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    pr, pi = S._vpu_dft(torch.from_numpy(xr), torch.from_numpy(xi), m, sign)
    got = pr.numpy() + 1j * pi.numpy()
    want = _oracle(xr.astype(np.float64) + 1j * xi, sign, axis=0)
    assert _relerr(got, ref) <= TOL
    assert _relerr(got, want) <= TOL
    assert _relerr(ref, want) <= TOL


LEVELS = {  # radix -> register levels; None: the dense p-term sum
    2: (2,), 3: (3,), 5: (5,), 8: (8,), 12: (4, 3), 16: (16,),
    20: (5, 4), 32: (8, 4), 50: (5, 5, 2), 64: (8, 8), 128: (16, 8),
    192: (8, 8, 3), 243: (3, 3, 3, 3, 3), 256: (16, 16),
    7: None, 14: None, 56: None, 112: None, 131: None}


@pytest.mark.parametrize("p", sorted(LEVELS))
def test_stage_form_and_levels(p):
    want = LEVELS[p]
    assert S.stage_form(p) == ("dense" if want is None else "bfly")
    if want is not None:
        assert S.bfly_levels(p) == want
        assert all(r in S.LEVEL_RADICES for r in want)
        assert int(np.prod(want)) == p


PLANS = {  # (n, radices, tl) -> the kernel's level plan
    (1024, (64, 16), 1): (
        3, 1, 1148, 2208,
        8, 8, 1, 1024, 128, 0, 1024, 1,
        8, 8, 8, 128, 128, 0, 1024, 4,
        16, 16, 64, 16, 2176, 0, 16, 0),
    (512, (32, 16), 16): (
        3, 1, 9212, 1120,
        8, 8, 1, 512, 64, 0, 512, 4,
        4, 4, 8, 64, 64, 0, 512, 0,
        16, 16, 32, 16, 1088, 0, 16, 0),
    (896, (56, 16), 1): (
        2, 2, 896, 1936,
        0, 56, 1, 896, 0, 112, 0, 0,
        16, 16, 56, 16, 1904, 0, 16, 0),
    (131, (131,), 1): (1, 2, 131, 262, 0, 131, 1, 131, 0, 0, 0, 0),
}


@pytest.mark.parametrize("key", sorted(PLANS))
def test_level_plan_table(key):
    n, radices, tl = key
    assert S.level_plan(n, radices, tl) == PLANS[key]
    assert S.form_label(radices) == {
        (64, 16): "bfly 64=8x8, bfly 16", (32, 16): "bfly 32=8x4, bfly 16",
        (56, 16): "dense 56, bfly 16", (131,): "dense 131"}[radices]


def _execute_plan(x, n, radices, sign):
    """The level plan run in numpy on the kernel's f32 root tables, read at
    the plan's offsets and strides as the kernel reads them."""
    plan = S.level_plan(n, tuple(radices))
    tab = S.kernel_table(n, radices, sign).astype(np.float64)
    B = x.shape[0]
    for lv in range(plan[0]):
        kind, r, done, rest, off_a, off_b, ln, _ = plan[4 + 8 * lv:12 + 8 * lv]
        q = rest // r
        j = np.arange(r)
        if kind == 0:
            roots = tab[off_a:off_a + r] + 1j * tab[off_a + r:off_a + 2 * r]
            F = roots[np.outer(j, j) % r]
            if q > 1:
                t = tab[off_b:off_b + rest] + 1j * tab[off_b + rest:
                                                       off_b + 2 * rest]
        else:
            t = tab[off_a:off_a + ln] + 1j * tab[off_a + ln:off_a + 2 * ln]
            # the table the butterfly level reads is w_len^e, e < len
            want = matrices.roots(ln, sign).astype(np.complex64)
            assert np.array_equal(t.astype(np.complex64), want)
            F = t[(np.outer(j, j) % r) * (ln // r)]
            t = t[::ln // rest]
        y = np.einsum("jk,bjqd->bkqd", F, x.reshape(B, r, q, done))
        if q > 1:
            w = t[np.outer(j, np.arange(q)) % rest]
            y = y * w[None, :, :, None]
        x = y.transpose(0, 2, 1, 3).reshape(B, n)
    return x


@pytest.mark.parametrize("n,radices", [
    (128, [128]), (1000, [50, 20]), (1024, [64, 16]), (1024, [32, 32]),
    (1024, [128, 8]), (768, [48, 16]), (1536, [96, 16]), (1920, [120, 16]),
    (2048, [128, 16]), (896, [56, 16]), (1792, [112, 16]), (131, [131]),
    (524, [131, 4]), (192, [192])])
@pytest.mark.parametrize("sign", [-1, +1])
def test_level_plan_computes_the_dft(n, radices, sign):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    assert S.radices_ok(n, radices)
    assert _relerr(_execute_plan(x, n, radices, sign), _oracle(x, sign)) \
        <= 1e-6


def _banks(r, done, tl, pad):
    """Banks of one warp's stores of output k1 = 0 of a level, threads on
    consecutive (c, d, j2) as the kernel assigns them."""
    out = []
    for t in range(32):
        c = t % tl
        jd = t // tl
        j2, d = divmod(jd, done)
        e = ((j2 * r) * done + d) * tl + c
        out.append((e + pad * (e >> 5)) % 32)
    return out


@pytest.mark.parametrize("n,radices,tl", [
    (1024, (64, 16), 1), (2048, (128, 16), 1), (512, (32, 16), 1),
    (512, (32, 16), 16), (128, (128,), 1)])
def test_pads_spread_a_warps_stores(n, radices, tl):
    plan = S.level_plan(n, radices, tl)
    m = n * tl
    for lv in range(plan[0] - 1):     # the last level stores to global
        _, r, done, _, _, _, _, pad = plan[4 + 8 * lv:12 + 8 * lv]
        if (m // r) >= 32:
            assert len(set(_banks(r, done, tl, pad))) == 32, (lv, r, done)
        assert (m - 1) + pad * ((m - 1) >> 5) < plan[2]


#: what the kernels take (csrc/stockham_rows.cuh kRowMaxSmem and kRowPts *
#: kRowThreads; csrc/c2c_2d.cu kMaxSmem and kTilePoints)
K1_MAX_SMEM, K1_TILE = 98304, 2048
K3_MAX_SMEM, K3_TILE = 180224, 8192


def _fits(plan, tl):
    """Every level of a plan is one the run-time form runs: a dense stage
    or a butterfly level of a radix it instantiates, whose root table steps
    evenly (len a multiple of rest), within MAX_LEVELS."""
    assert 1 <= plan[0] <= S.MAX_LEVELS
    for lv in range(plan[0]):
        kind, r, done, rest, _, _, ln, pad = plan[4 + 8 * lv:12 + 8 * lv]
        assert rest % r == 0 and done >= 1 and pad >= 0
        if kind:
            assert kind == r and r in S.LEVEL_RADICES
            assert ln % rest == 0 and ln >= rest
            assert (rest // r) * done * tl < 2 ** 31


@pytest.mark.parametrize("lo,hi", [(128, 512), (512, 1024), (1024, 1536),
                                   (1536, 2049)])
def test_every_schedule_fits_k1(lo, hi):
    """Every schedule the planner can hand K1 in its window (the ranked one
    and MEASURE's alternatives) has a plan the kernel runs, within its
    shared memory and tile."""
    for n in range(lo, hi):
        try:
            cands = [S.choose_radices(n)] + S.alternative_radices(n)
        except ValueError:
            continue
        for radices in cands:
            if not S.radices_ok(n, radices):
                continue
            plan = S.level_plan(n, tuple(radices))
            _fits(plan, 1)
            rpb = S.rows_per_block(n)
            assert rpb * n <= K1_TILE
            assert S.plan_smem(plan, rpb) <= K1_MAX_SMEM, (n, radices)


@pytest.mark.parametrize("n1", [128, 256, 384, 512, 640, 768, 1024, 2048])
def test_every_plane_fits_k3(n1):
    """Every plane the route gate sends to K3 with n1 rows has plans the
    kernel runs, within its shared memory and tiles."""
    for n2 in range(128, 2049, 128):
        if not S.applicable_2d(n1, n2, np.float32, "cuda"):
            continue
        r1, r2 = S.choose_radices(n1), S.choose_radices(n2)
        rows, tc = fused2d.tiles(n1, n2)
        p2 = S.level_plan(n2, tuple(r2), 1)
        p1 = S.level_plan(n1, tuple(r1), tc)
        _fits(p2, 1)
        _fits(p1, tc)
        assert rows * n2 <= K3_TILE and n1 * tc <= K3_TILE
        assert fused2d.smem_2d(p2, p1, rows) <= K3_MAX_SMEM, (n1, n2)
        # shared memory never keeps a plane off K3's ring: only a dense
        # stage or tiles narrower than 4 columns do
        assert fused2d.ring_fits(p2, p1, rows, n2, tc, [0]) == \
            (p2[1] == p1[1] == 1 and tc % 4 == 0), (n1, n2)


#: what K2, K4 and K1's wide form take (csrc/inner_c2c.cu kMaxSmem,
#: kTilePoints, 512 threads of up to 16 points in a level; csrc/r2c.cu
#: kMaxSmem, kGroupPoints, 256 threads of up to 8; csrc/stockham_rows.cuh
#: kWideThreads of kRowPts, kRowMaxSmem)
K2_MAX_SMEM, K2_TILE, K2_THREADS, K2_PTS = 180224, 8192, 512, 16
K4_MAX_SMEM, K4_GROUP, K4_THREADS, K4_PTS = 98304, 2048, 256, 8
K6_MAX_SMEM, K6_GROUP, K6_THREADS, K6_PTS = 98304, 2048, 256, 8
K1_WIDE, K1_WIDE_THREADS = 4096, 512


def _threads_hold(plan, tl, nr, threads, pts):
    """Every butterfly level's butterflies over nr transforms fit the
    block: a thread holds at most ceil(pts / r) of them (bfly_level's K)."""
    for lv in range(plan[0]):
        kind, r, done, rest = plan[4 + 8 * lv:8 + 8 * lv]
        if kind:
            assert nr * (rest // r) * done * tl <= -(-pts // r) * threads


def _bfly_where_smooth(plan, radices):
    """Every level of a 2-3-5-smooth stage is a butterfly level: the plan
    holds exactly one dense level (a stage() call) per radix with a prime
    factor of 7 or more."""
    kinds = [plan[4 + 8 * lv] for lv in range(plan[0])]
    assert kinds.count(0) == sum(S.stage_form(p) == "dense"
                                 for p in radices)


def _schedules(n):
    try:
        cands = [S.choose_radices(n)] + S.alternative_radices(n)
    except ValueError:
        return []
    return [r for r in cands if S.radices_ok(n, r)]


@pytest.mark.parametrize("lo,hi", [(2, 256), (256, 768), (768, 1280),
                                   (1280, 2049)])
def test_every_tile_fits_k2(lo, hi):
    """Every (n, tl) that ``inner.tile_width`` can hand K2, with as many
    planes a group as ``inner.planes_per_group`` can give it, has a plan
    the kernel runs, within its shared memory, threads and tile."""
    for n in range(lo, hi):
        for radices in _schedules(n):
            tl = 1
            while n * tl <= K2_TILE:
                assert inner.tile_width(n, tl) == tl
                gp = inner.planes_per_group(n, tl, 1 << 20)
                plan = S.level_plan(n, tuple(radices), tl)
                _fits(plan, tl)
                _bfly_where_smooth(plan, radices)
                assert gp * n * tl <= K2_TILE
                _threads_hold(plan, tl, gp, K2_THREADS, K2_PTS)
                assert S.plan_smem(plan, gp) <= K2_MAX_SMEM, (n, radices, tl)
                tl *= 2


@pytest.mark.parametrize("lo,hi", [(2, 1025), (1025, 2049)])
def test_every_schedule_fits_k4(lo, hi):
    """Every m-point schedule K4 can be handed (n = 2m), with its rows a
    group, has a plan the kernel runs, within its shared memory, threads
    and group."""
    for m in range(lo, hi):
        for radices in _schedules(m):
            plan = S.level_plan(m, tuple(radices))
            rpb = S.rows_per_block(m)
            _fits(plan, 1)
            _bfly_where_smooth(plan, radices)
            assert rpb * m <= K4_GROUP
            _threads_hold(plan, 1, rpb, K4_THREADS, K4_PTS)
            assert RS.r2c_smem(plan, m, rpb) <= K4_MAX_SMEM, (m, radices)


@pytest.mark.parametrize("lo,hi", [(2, 1025), (1025, 2049)])
def test_every_schedule_fits_k6(lo, hi):
    """Every m-point schedule K6 can be handed (n = 2m), with its rows a
    group, has a plan the kernel runs, within its shared memory (tables,
    the v table and the level buffers), threads and group."""
    for m in range(lo, hi):
        for radices in _schedules(m):
            plan = S.level_plan(m, tuple(radices))
            rpb = S.rows_per_block(m)
            _fits(plan, 1)
            _bfly_where_smooth(plan, radices)
            assert rpb * m <= K6_GROUP
            _threads_hold(plan, 1, rpb, K6_THREADS, K6_PTS)
            assert RS.c2r_smem(plan, m, rpb) <= K6_MAX_SMEM, (m, radices)


@pytest.mark.parametrize("lo,hi", [(2, 1025), (1025, 2049)])
def test_every_tile_fits_k5(lo, hi):
    """Every m-point schedule K5 can be handed (n = 2m), at every tile
    width ``RS.r2c_inner_tile`` can pick for it, has a plan the kernel runs,
    within its shared memory (tables, buffers and Z), threads and tile."""
    for m in range(lo, hi, 7 if hi > 1025 else 3):
        for radices in _schedules(m):
            for L in (1, 5, 1 << 20):
                tl = RS.r2c_inner_tile(m, L, radices)
                assert tl & (tl - 1) == 0 and m * tl <= RS.R2C_INNER_TILE
                plan = S.level_plan(m, tuple(radices), tl)
                _fits(plan, tl)
                _bfly_where_smooth(plan, radices)
                _threads_hold(plan, tl, 1, K2_THREADS, K2_PTS)
                assert RS.r2c_inner_smem(plan, m, tl) <= \
                    RS.R2C_INNER_MAX_SMEM, (m, radices, tl)


def test_every_wide_schedule_fits_k1():
    """Every schedule K1's wide form takes (two butterfly radices of at
    most 64 above MAX_N) has a plan it runs: one row a block, within its
    shared memory and threads; the reference's [n/h, h] at 4096 is one."""
    rads = [r for r in range(2, 65) if S.vpu_last_ok(r, 1)]
    seen = set()
    for a in rads:
        for b in rads:
            n = a * b
            if not S.wide_ok(n, [a, b]):
                assert not S.MAX_N < n <= S.ROW_MAX_N
                continue
            seen.add((a, b))
            plan = S.level_plan(n, (a, b))
            _fits(plan, 1)
            assert S.rows_per_block(n) == 1 and n <= K1_WIDE
            _threads_hold(plan, 1, 1, K1_WIDE_THREADS, 8)
            assert S.plan_smem(plan, 1) <= K1_MAX_SMEM, (a, b)
    assert (64, 64) in seen and S.wide_ok(4096, [64, 64])
    assert not S.wide_ok(4096, [128, 32]) and not S.wide_ok(2048, [64, 32])
    assert not S.schedule_ok(4096, [64, 64]) and \
        S.schedule_ok(4096, [64, 64], "all")


def _emulate_levels(plan, tab, buf, tl, nr, store, direct=None):
    """The kernel's ``run_levels``, index for index, in numpy: `buf` holds
    nr transforms at the plan's row stride as the load pass leaves them
    (unpadded), or ``direct`` = (input, row stride, point stride) is what
    a first butterfly level reads in its place; each butterfly level reads
    its butterflies at the padded addresses the previous level wrote,
    computes the r-point DFT and the twiddle from the kernel's own f32
    table (``tab``, in float64) at the level's offsets and strides, and
    writes a fresh buffer at its own pad (so a slot no level wrote reads as
    NaN); a dense stage reads and writes unpadded buffers.  The last level
    hands (row, o, c, value) to `store`."""
    rs = plan[2]
    pad_in = 0
    src, rs_in, ld_in = (buf, rs, tl) if direct is None else direct
    for lv in range(plan[0]):
        kind, r, done, rest, off_a, off_b, ln, pad = \
            plan[4 + 8 * lv:12 + 8 * lv]
        q = rest // r
        w = np.arange(nr * q * done * tl)
        row, t = np.divmod(w, q * done * tl)
        jd, c = np.divmod(t, tl)
        j2, d = np.divmod(jd, done)
        j = np.arange(r)[:, None]
        if kind:
            roots = tab[off_a:off_a + ln] + 1j * tab[off_a + ln:off_a + 2 * ln]
            F = roots[(j * j.T % r) * (ln // r)]
            tw = roots[(j * j2 % rest) * (ln // rest)]
        else:
            roots = tab[off_a:off_a + r] + 1j * tab[off_a + r:off_a + 2 * r]
            F = roots[j * j.T % r]
            tw = np.ones((r, len(w)))
            if q > 1:
                tw = (tab[off_b:off_b + rest]
                      + 1j * tab[off_b + rest:off_b + 2 * rest])[j * j2 % rest]
        e = (j * q * done + jd) * ld_in + c
        y = (F @ src[row * rs_in + e + pad_in * (e >> 5)]) * tw
        o = (j2 * r + j) * done + d
        if lv == plan[0] - 1:
            store(np.broadcast_to(row, o.shape), o,
                  np.broadcast_to(c, o.shape), y)
            return
        e = o * tl + c
        src, rs_in, ld_in = np.full(nr * rs, np.nan, complex), rs, tl
        src[row * rs + e + pad * (e >> 5)] = y
        pad_in = pad


def _emulate_k2(x, radices, sign):
    """K2 on complex (pre, n, L) as the kernel walks it: groups of gp
    planes, tiles of tl columns, a full tile read by a first butterfly
    level straight from the input (rows n * L apart, points L apart), else
    loaded with the edge tile zero-filled past L; columns past L never
    stored."""
    pre, n, L = x.shape
    tl = inner.tile_width(n, L)
    gp = inner.planes_per_group(n, L, pre)
    plan = S.level_plan(n, tuple(radices), tl)
    tab = S.kernel_table(n, radices, sign).astype(np.float64)
    y = np.full(x.shape, np.nan, complex)
    for b0 in range(0, pre, gp):
        nr = min(gp, pre - b0)
        for l0 in range(0, L, tl):
            width = min(tl, L - l0)
            buf = np.zeros(nr * plan[2], complex)
            for row in range(nr):
                tile = np.zeros((n, tl), complex)
                tile[:, :width] = x[b0 + row, :, l0:l0 + width]
                buf[row * plan[2]:row * plan[2] + n * tl] = tile.ravel()

            def store(row, o, c, v, b0=b0, l0=l0, width=width):
                keep = c < width
                y[b0 + row[keep], o[keep], l0 + c[keep]] = v[keep]
            direct = None
            if plan[4] != 0 and width == tl:
                direct = (x.reshape(-1)[b0 * n * L + l0:], n * L, L)
            _emulate_levels(plan, tab, buf, tl, nr, store, direct)
    return y


def _emulate_k4(x, radices):
    """K4 on real (B, n) as the kernel walks it: groups of rpb rows, the
    pack z = x[2j] + i x[2j+1] read by a first butterfly level straight
    from the rows (else loaded into the level buffer), the levels with the
    last storing Z at row * m + o, then the untangle with the kernel's w
    table."""
    B, n = x.shape
    m = n // 2
    plan = S.level_plan(m, tuple(radices))
    rpb = S.rows_per_block(m)
    tab = RS._real_table(n, radices, -1).astype(np.float64)
    t0 = plan[3]
    wt = tab[t0:t0 + m + 1] + 1j * tab[t0 + m + 1:t0 + 2 * m + 2]
    out = np.full((B, m + 1), np.nan, complex)
    k = np.arange(m + 1)
    k0, k1 = np.where(k == m, 0, k), np.where(k == 0, 0, m - k)
    for r0 in range(0, B, rpb):
        nr = min(rpb, B - r0)
        buf = np.zeros(nr * plan[2], complex)
        for row in range(nr):
            buf[row * plan[2]:row * plan[2] + m] = \
                x[r0 + row, 0::2] + 1j * x[r0 + row, 1::2]
        Z = np.full(nr * m, np.nan, complex)

        def store(row, o, c, v, Z=Z):
            Z[row * m + o] = v
        direct = None
        if plan[4] != 0:
            rows = x[r0:r0 + nr].reshape(-1)
            direct = (rows[0::2] + 1j * rows[1::2], m, 1)
        _emulate_levels(plan, tab, buf, 1, nr, store, direct)
        Z = Z.reshape(nr, m)
        a, cb = Z[:, k0], np.conj(Z[:, k1])
        out[r0:r0 + nr] = 0.5 * (a + cb) + wt * (-0.5j) * (a - cb)
    return out


@pytest.mark.parametrize("n,radices,sign,shape", [
    (512, [32, 16], -1, (1, 512, 40)),       # tiles of 16, edge of 8
    (2048, [128, 16], +1, (2, 2048, 5)),     # tiles of 4, edge of 1
    (32, [32], -1, (5, 32, 128)),            # two planes a group, ragged
    (1000, [50, 20], +1, (2, 1000, 3)),      # radix-5 levels, one group
    (896, [56, 16], -1, (1, 896, 9)),        # a dense stage
    (128, [128], +1, (3, 128, 1))])          # one column, three planes
def test_k2_levels_match_reference(n, radices, sign, shape, monkeypatch):
    """K2's level plan for tiles of tl > 1 columns, executed in numpy as
    the kernel executes it, against the reference's axis -2 kernel
    (``_kernel_inner`` on ``_stages``, interpret mode) within 2e-5 and
    numpy within 1e-5."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    rng = np.random.default_rng(n + shape[-1])
    xr, xi = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    got = _emulate_k2(xr + 1j * xi.astype(np.float64), radices, sign)
    ref = PS.build_pallas_c2c_split_inner(
        {"alg": "pallas", "n": n, "radices": radices}, sign, np.float32)
    wr, wi = jax.jit(ref)(jnp.asarray(xr), jnp.asarray(xi))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    assert not np.isnan(got).any()
    assert _relerr(got, want) <= 2e-5
    assert _relerr(got, _oracle(xr + 1j * xi.astype(np.float64), sign,
                                axis=-2)) <= TOL


@pytest.mark.parametrize("n,radices,batch", [
    (1024, [32, 16], 5),                     # 4 rows a group, ragged
    (2048, [64, 16], 3),                     # 2 rows a group, ragged
    (1000, [25, 20], 7),                     # radix-5 levels
    (1792, [56, 16], 3),                     # a dense stage
    (4096, [128, 16], 2)])                   # one row a group
def test_k4_levels_and_untangle_match_reference(n, radices, batch,
                                                monkeypatch):
    """K4's m-point level plan executed in numpy as the kernel executes
    it, Z read back from its region of shared memory, and the untangle,
    against the reference's r2c kernel (``_kernel_r2c``, interpret mode)
    within 2e-5 and numpy within 1e-5."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    assert S.radices_ok(n // 2, radices)
    x = np.random.default_rng(n + batch).standard_normal(
        (batch, n)).astype(np.float32)
    got = _emulate_k4(x.astype(np.float64), radices)
    want = np.asarray(jax.jit(PS.build_pallas_r2c(
        {"alg": "pallas_r2c", "n": n, "radices": radices}, np.float32))(x))
    assert not np.isnan(got).any()
    assert _relerr(got, want) <= 2e-5
    assert _relerr(got, np.fft.rfft(x.astype(np.float64))) <= TOL


def _emulate_k6(X, radices):
    """K6 on half spectra (B, m+1) as the kernel walks it: groups of rpb
    rows; the tangle, one pair (k, m - k) of a row at a time, reading X[k]
    and X[m - k] (Im X[0] and Im X[m] dropped) and writing 2Z[k] and
    2Z[m - k] with the kernel's v table straight into the level buffer
    (every other slot NaN); the levels, the last storing point o of a row
    as (y[2o], y[2o + 1])."""
    B, h = X.shape
    m = h - 1
    n = 2 * m
    plan = S.level_plan(m, tuple(radices))
    rpb = S.rows_per_block(m)
    tab = RS._real_table(n, radices, +1).astype(np.float64)
    t0 = plan[3]
    v = tab[t0:t0 + h] + 1j * tab[t0 + h:t0 + 2 * h]
    out = np.full((B, n), np.nan)
    k = np.arange(m // 2 + 1)
    j = m - k
    for r0 in range(0, B, rpb):
        nr = min(rpb, B - r0)
        buf = np.full(nr * plan[2], np.nan, complex)
        for row in range(nr):
            x = X[r0 + row]
            a, c = x.real[k], x.real[j]
            b = np.where(k == 0, 0.0, x.imag[k])
            d = np.where(k == 0, 0.0, x.imag[j])
            base = row * plan[2]
            buf[base + k] = (a + c) + 1j * (b - d) \
                + 1j * ((a - c) + 1j * (b + d)) * v[k]
            two = (k != 0) & (k != j)
            zj = (c + a) + 1j * (d - b) + 1j * ((c - a) + 1j * (d + b)) * v[j]
            buf[base + j[two]] = zj[two]

        def store(row, o, c, val, r0=r0):
            out[r0 + row, 2 * o] = val.real
            out[r0 + row, 2 * o + 1] = val.imag
        _emulate_levels(plan, tab, buf, 1, nr, store)
    return out


@pytest.mark.parametrize("n,radices,batch", [
    (1024, [32, 16], 5),                     # 4 rows a group, ragged
    (2048, [64, 16], 3),                     # 2 rows a group, ragged
    (1000, [25, 20], 7),                     # radix-5 levels
    (1792, [56, 16], 3),                     # a dense stage
    (1792, [16, 56], 2),                     # a dense last stage
    (4096, [128, 16], 2),                    # one row a group
    (512, [256], 9)])                        # the DCT-III's child
def test_k6_levels_and_tangle_match_reference(n, radices, batch,
                                              monkeypatch):
    """K6's tangle into the level buffer, its m-point level plan and its
    interleaved store, executed in numpy as the kernel executes them, on
    random half spectra (Im X[0] and Im X[m] nonzero, so a leak shows),
    against the reference's c2r kernel (``_kernel_c2r``, interpret mode)
    within 2e-5 and numpy within 1e-5."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    assert S.radices_ok(n // 2, radices)
    rng = np.random.default_rng(n + batch)
    X = (rng.standard_normal((batch, n // 2 + 1))
         + 1j * rng.standard_normal((batch, n // 2 + 1))).astype(np.complex64)
    got = _emulate_k6(X.astype(np.complex128), radices)
    want = np.asarray(jax.jit(PS.build_pallas_c2r(
        {"alg": "pallas_c2r", "n": n, "radices": radices}, np.float32))(X))
    assert not np.isnan(got).any()
    assert _relerr(got, want) <= 2e-5
    assert _relerr(got, np.fft.irfft(X.astype(np.complex128), n) * n) <= TOL


@pytest.mark.parametrize("n,radices", [
    (1024, [32, 16]),                        # the 1-D c2r path
    (2048, [64, 16]),                        # the 2-D c2r path's rows
    (512, [256])])                           # the DCT-III's child
def test_k6_store_is_whole_sectors(n, radices):
    """K6's last level stores each point as one float2 at row * m + o,
    o = k1 * done + d: on the paths' plans every warp's store of one k1
    fills whole 32-byte sectors, the fewest there are (8 a warp), in
    runs of consecutive d, so the store needs no Z region."""
    m = n // 2
    plan = S.level_plan(m, tuple(radices))
    rpb = S.rows_per_block(m)
    last = 4 + 8 * (plan[0] - 1)
    kind, r, done, rest = plan[last:last + 4]
    assert kind == r and rest == r                  # a butterfly, q = 1
    w = np.arange(rpb * done)                       # the level's butterflies
    row, d = np.divmod(w, done)
    for k1 in range(r):
        byte = 8 * (row * m + k1 * done + d)        # group base: 8m-aligned
        for warp in range(0, len(w), 32):
            sectors = np.unique(byte[warp:warp + 32] // 32)
            assert len(sectors) == 8, (k1, warp)


def _emulate_k5(x, radices):
    """K5 on real (pre, n, L) as the kernel walks it: tiles of tl columns
    (``RS.r2c_inner_tile``) of one pre index; a full tile read by a first
    butterfly level straight from the input, packed point j of column c
    at x[2j, c] + i x[2j+1, c] (points 2L apart, the imaginary part L
    after the real), else loaded with the edge tile zero-filled past L;
    the levels on ``stockham.level_plan(m, radices, tl)``, the last one
    storing Z at o * tl + c; then the untangle with the kernel's w table,
    columns past L never stored."""
    pre, n, L = x.shape
    m = n // 2
    tl = RS.r2c_inner_tile(m, L, radices)
    plan = S.level_plan(m, tuple(radices), tl)
    tab = RS._real_table(n, radices, -1).astype(np.float64)
    t0 = plan[3]
    wt = tab[t0:t0 + m + 1] + 1j * tab[t0 + m + 1:t0 + 2 * m + 2]
    out = np.full((pre, m + 1, L), np.nan, complex)
    k = np.arange(m + 1)
    k0, k1 = np.where(k == m, 0, k), np.where(k == 0, 0, m - k)
    for b in range(pre):
        for l0 in range(0, L, tl):
            width = min(tl, L - l0)
            tile = np.zeros((m, tl), complex)
            tile[:, :width] = x[b, 0::2, l0:l0 + width] \
                + 1j * x[b, 1::2, l0:l0 + width]
            buf = np.zeros(plan[2], complex)
            buf[:m * tl] = tile.ravel()
            Z = np.full(m * tl, np.nan, complex)

            def store(row, o, c, v, Z=Z):
                Z[o * tl + c] = v
            direct = None
            if plan[4] != 0 and width == tl:
                flat = x[b].reshape(-1)[l0:]
                direct = (flat[:-L] + 1j * flat[L:], 0, 2 * L)
            _emulate_levels(plan, tab, buf, tl, 1, store, direct)
            Z = Z.reshape(m, tl)
            a, cb = Z[k0], np.conj(Z[k1])
            y = 0.5 * (a + cb) + wt[:, None] * (-0.5j) * (a - cb)
            out[b, :, l0:l0 + width] = y[:, :width]
    return out


@pytest.mark.parametrize("n,radices,shape", [
    (512, [16, 16], (2, 512, 200)),          # tiles of 32, edge of 8
    (2048, [64, 16], (1, 2048, 20)),         # tiles of 8, edge of 4
    (1000, [25, 20], (2, 1000, 7)),          # radix-5 levels, one edge tile
    (1792, [56, 16], (1, 1792, 5)),          # a dense stage
    (256, [128], (3, 256, 1))])              # one column, three planes
def test_k5_levels_and_untangle_match_reference(n, radices, shape,
                                                monkeypatch):
    """K5's m-point level plan for tiles of tl columns, its packed first
    level read from the two input rows and the untangle along axis -2,
    executed in numpy as the kernel executes them on its own tables and
    pads, against the reference's axis -2 r2c kernel
    (``_kernel_r2c_inner``, interpret mode; its input padded with zero
    columns to whole lane tiles, which leaves the other columns as they
    are) within 2e-5 and numpy within 1e-5, with an L that is not a
    multiple of tl."""
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    assert S.radices_ok(n // 2, radices)
    x = np.random.default_rng(n + shape[-1]).standard_normal(
        shape).astype(np.float32)
    got = _emulate_k5(x.astype(np.float64), radices)
    L = shape[-1]
    xp = np.zeros(shape[:-1] + (-(-L // 128) * 128,), np.float32)
    xp[..., :L] = x
    wr, wi = jax.jit(PS.build_pallas_r2c_inner(
        {"alg": "pallas_r2c", "n": n, "radices": radices}, np.float32))(
        jnp.asarray(xp))
    want = (np.asarray(wr) + 1j * np.asarray(wi))[..., :L]
    assert not np.isnan(got).any()
    assert _relerr(got, want) <= 2e-5
    assert _relerr(got, np.fft.rfft(x.astype(np.float64), axis=-2)) <= TOL


@pytest.mark.parametrize("n,radices", [(1024, [64, 16]), (4096, [64, 64]),
                                       (896, [56, 16])])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k1_levels_match_numpy(n, radices, sign):
    """K1's row plan (its wide form's at 4096) executed in numpy as the
    kernel executes it, groups of rows included, against numpy."""
    rng = np.random.default_rng(n)
    B = 2 * S.rows_per_block(n) + 1
    x = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    plan = S.level_plan(n, tuple(radices))
    tab = S.kernel_table(n, radices, sign).astype(np.float64)
    rpb = S.rows_per_block(n)
    y = np.full(x.shape, np.nan, complex)
    for r0 in range(0, B, rpb):
        nr = min(rpb, B - r0)
        buf = np.zeros(nr * plan[2], complex)
        for row in range(nr):
            buf[row * plan[2]:row * plan[2] + n] = x[r0 + row]

        def store(row, o, c, v, r0=r0):
            y[r0 + row, o] = v
        _emulate_levels(plan, tab, buf, 1, nr, store)
    assert _relerr(y, _oracle(x, sign)) <= 1e-6


PTXAS = """\
ptxas info    : Compiling entry function '_ZN15fftw3_tpu_torch48_GLOBAL__N__\
d09eb3ab_15_stockham_c2c_cu_a56885a119stockham_c2c_kernelILi0ELb1ELb0ENS_7\
DynPlanEEEvPKfS3_PfS4_S3_NS_9LevelPlanEiiiS3_i' for 'sm_90a'
ptxas info    : Function properties for _ZN15fftw3_tpu_torch48_GLOBAL__N__\
d09eb3ab_15_stockham_c2c_cu_a56885a119stockham_c2c_kernelILi0ELb1ELb0ENS_7\
DynPlanEEEvPKfS3_PfS4_S3_NS_9LevelPlanEiiiS3_i
    1536 bytes stack frame, 36 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 1536 bytes cumulative \
stack size
ptxas info    : Function properties for _ZN15fftw3_tpu_torch10bfly_levelILi8\
ELi8ELi0ELb0ENS_5NoMapEEEvPKfS3_PfS4_T2_NS_5RootsENS_6DynGeoEi
    0 bytes stack frame, 64 bytes spill stores, 64 bytes spill loads
ptxas info    : Function properties for _ZN41_GLOBAL__N__010ddffd_9_c2c_2d_cu_\
7552fe6a13c2c_2d_kernelEPKfS1_PfS2_S1_iiiiiiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers
"""


def test_register_report_reads_ptxas(tmp_path, monkeypatch):
    """What phase 2 of chip_smoke.py prints: registers, spill stores and
    stack frame per kernel, the kernels named from their mangled names,
    device functions that are no kernel left out."""
    from fftw3_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_library_path",
                        lambda: tmp_path / "lib.so")
    assert _build.register_report() == {}
    (tmp_path / "lib.ptxas.txt").write_text(PTXAS)
    assert _build.register_report() == {
        "stockham_c2c_kernel<0,1,0>": (80, 36, 1536),
        "c2c_2d_kernel": (60, 0, 0)}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.ones(2, 1024)
    table = torch.from_numpy(S.kernel_table(1024, [64, 16], -1))
    with pytest.raises(ValueError, match="CUDA"):
        ablate.ablate_cuda(x, x, [64, 16], table, "bfly", "full")
    w = torch.ones(2, 4096)
    with pytest.raises(ValueError, match="CUDA"):
        S.stockham_c2c_cuda(w, w, [64, 64], torch.from_numpy(
            S.kernel_table(4096, [64, 64], -1)))
    with pytest.raises(ValueError, match="CUDA"):
        copyfloor.copy_inner_cuda(x.reshape(2, 64, 16), x.reshape(2, 64, 16))
    with pytest.raises(ValueError, match="CUDA"):
        copyfloor.copy_rows_cuda(x, x)
    assert fused2d.smem_2d(S.level_plan(512, (32, 16), 1),
                           S.level_plan(512, (32, 16), 16), 16) == 89856


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

K1_CASES = [(128, [128]), (256, [256]), (512, [32, 16]), (1000, [50, 20]),
            (1024, [64, 16]), (1024, [32, 32]), (1024, [128, 8]),
            (768, [48, 16]), (1536, [96, 16]), (2048, [128, 16]),
            (192, [192]), (896, [56, 16]), (1792, [112, 16]), (131, [131]),
            (524, [131, 4])]


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", K1_CASES)
@pytest.mark.parametrize("batch", [1, 37, 130])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k1_matches_twin_and_complex128(cuda_device, n, radices, batch,
                                        sign):
    rng = np.random.default_rng(n + batch)
    xr, xi = (torch.from_numpy(rng.standard_normal((batch, n)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    table = S.device_table(n, tuple(radices), sign, cuda_device)
    before = S.launches
    kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, sign)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL
    x = xr.cpu().numpy().astype(np.float64) + 1j * xi.cpu().numpy()
    assert _relerr(got, _oracle(x, sign)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("q,radices,p,store", [
    (128, [128], 32, False), (128, [128], 128, True),
    (512, [32, 16], 8, False), (2048, [128, 16], 64, True)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k1_fourstep_options(cuda_device, q, radices, p, store, sign):
    rng = np.random.default_rng(q + p)
    g = 3
    xr, xi = (torch.from_numpy(rng.standard_normal((g * p, q)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    table = S.device_table(q, tuple(radices), sign, cuda_device)
    w = S.device_pretwiddle(p, q, sign, cuda_device)
    kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table, pretwiddle=w,
                                 store_transposed=store)
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, sign, pretwiddle_p=p,
                                  store_transposed=store)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL
    x = (xr.cpu().numpy().astype(np.float64) + 1j * xi.cpu().numpy()
         ).reshape(g, p, q) * matrices.twiddle_2d(p, q, sign)
    want = _oracle(x, sign)
    if store:
        want = want.transpose(0, 2, 1)
    assert _relerr(got.reshape(want.shape), want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(128, 128), (256, 1024), (512, 512),
                                   (384, 768), (1024, 256), (128, 896)])
@pytest.mark.parametrize("pre", [1, 3, 64])
def test_k3_over_the_2d_grid(cuda_device, n1, n2, pre):
    rng = np.random.default_rng(n1 + pre)
    r1, r2 = S.choose_radices(n1), S.choose_radices(n2)
    xr, xi = (torch.from_numpy(rng.standard_normal((pre, n1, n2)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    for sign in (-1, +1):
        table = fused2d.device_table_2d(n1, tuple(r1), n2, tuple(r2), sign,
                                        cuda_device)
        kr, ki = fused2d.c2c_2d_cuda(xr, xi, r1, r2, table)
        tr, ti = fused2d.c2c_2d_torch(xr, xi, r1, r2, sign)
        k = torch.complex(kr, ki)
        assert float((k - torch.complex(tr, ti)).abs().max()
                     / torch.complex(tr, ti).abs().max()) <= TOL
        x = torch.complex(xr, xi).to(torch.complex128)
        want = torch.fft.fft2(x) if sign < 0 else \
            torch.fft.ifft2(x, norm="forward")
        assert float((k.to(torch.complex128) - want).abs().max()
                     / want.abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("radices", [[64, 16], [32, 32]])
def test_e5_full_arms(cuda_device, radices):
    """E5's bfly full arm is K1 bit for bit; its dense full arm is the dense
    K1, within TOL of the twin; every arm launches."""
    n, B = 1024, 37
    rng = np.random.default_rng(5)
    xr, xi = (torch.from_numpy(rng.standard_normal((B, n)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    table = S.device_table(n, tuple(radices), -1, cuda_device)
    kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table)
    br, bi = ablate.ablate_cuda(xr, xi, radices, table, "bfly", "full")
    assert torch.equal(kr, br) and torch.equal(ki, bi)
    dr, di = ablate.ablate_cuda(xr, xi, radices, table, "dense", "full")
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, -1)
    t = torch.complex(tr, ti)
    assert float((torch.complex(dr, di) - t).abs().max()
                 / t.abs().max()) <= TOL
    for form in ablate.FORMS:
        for arm in ablate.ARMS[1:]:
            yr, _ = ablate.ablate_cuda(xr, xi, radices, table, form, arm)
            assert yr.shape == (B, n)
    torch.cuda.synchronize()


def _cuda_planes(device, seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device) for _ in range(2))


K2_CASES = [(512, [32, 16], (3, 512, 40)), (2048, [128, 16], (2, 2048, 1025)),
            (32, [32], (5, 32, 128)), (1000, [50, 20], (2, 1000, 3)),
            (896, [56, 16], (1, 896, 9)), (128, [128], (3, 128, 1)),
            (8, [8], (7, 8, 4096))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices,shape", K2_CASES)
@pytest.mark.parametrize("sign", [-1, +1])
def test_k2_matches_twin_and_complex128(cuda_device, n, radices, shape,
                                        sign):
    """K2 on ragged plane groups, edge tiles and a dense stage, both
    signs, against its twin and complex128."""
    xr, xi = _cuda_planes(cuda_device, n + shape[-1], shape)
    table = S.device_table(n, tuple(radices), sign, cuda_device)
    before = inner.launches
    kr, ki = inner.inner_c2c_cuda(xr, xi, radices, table)
    torch.cuda.synchronize()
    assert inner.launches == before + 1
    tr, ti = inner.inner_c2c_torch(xr, xi, radices, sign)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL
    x = xr.cpu().numpy().astype(np.float64) + 1j * xi.cpu().numpy()
    assert _relerr(got, _oracle(x, sign, axis=-2)) <= TOL


@pytest.mark.cuda
def test_k2_gradient_is_the_opposite_sign_launch(cuda_device):
    n, radices, shape = 512, [32, 16], (3, 512, 40)
    split = inner.build_pallas_c2c_split_inner(
        {"alg": "pallas", "n": n, "radices": radices}, -1, np.float32,
        cuda_device)
    xr, xi = (t.requires_grad_() for t in _cuda_planes(cuda_device, 1,
                                                       shape))
    gr, gi = _cuda_planes(cuda_device, 2, shape)
    yr, yi = split(xr, xi)
    before = inner.launches
    torch.autograd.backward([yr, yi], [gr, gi])
    assert inner.launches == before + 1
    wr, wi = inner.inner_c2c_cuda(gr, gi, radices, S.device_table(
        n, tuple(radices), +1, cuda_device))
    assert torch.equal(xr.grad, wr) and torch.equal(xi.grad, wi)


K5_CASES = [(512, [16, 16], (2, 512, 200)), (2048, [64, 16], (1, 2048, 20)),
            (1000, [25, 20], (2, 1000, 7)), (1792, [56, 16], (1, 1792, 5)),
            (256, [128], (3, 256, 1)), (2048, [64, 16], (8, 2048, 2048))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices,shape", K5_CASES)
def test_k5_matches_twin_and_float64(cuda_device, n, radices, shape):
    """K5 on edge tiles, radix-5 levels, a dense stage, one column and the
    swapped 2-D path's full-width shape, against its twin in the butterfly
    stage form and float64."""
    x = torch.from_numpy(np.random.default_rng(n + shape[-1])
                         .standard_normal(shape).astype(np.float32)) \
        .to(cuda_device)
    before = RS.r2c_inner_launches
    kr, ki = RS.r2c_inner_cuda(x, radices, RS.device_table(
        n, tuple(radices), -1, cuda_device))
    torch.cuda.synchronize()
    assert RS.r2c_inner_launches == before + 1
    tr, ti = RS.r2c_inner_torch(x, radices, "all")
    got = (kr.double() + 1j * ki.double()).cpu().numpy()
    assert _relerr(got, (tr.double() + 1j * ti.double()).cpu().numpy()) \
        <= TOL
    assert _relerr(got, np.fft.rfft(x.double().cpu().numpy(), axis=-2)) \
        <= TOL


K4_CASES = [(1024, [32, 16], 5), (2048, [64, 16], 3), (1000, [25, 20], 7),
            (1792, [56, 16], 3), (4096, [128, 16], 2), (256, [128], 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices,batch", K4_CASES)
def test_k4_matches_twin_and_complex128(cuda_device, n, radices, batch):
    """K4 on ragged row groups and a dense stage against its twin and
    complex128."""
    x = torch.from_numpy(np.random.default_rng(n + batch).standard_normal(
        (batch, n)).astype(np.float32)).to(cuda_device)
    before = RS.r2c_launches
    kr, ki = RS.r2c_cuda(x, radices, RS.device_table(
        n, tuple(radices), -1, cuda_device))
    torch.cuda.synchronize()
    assert RS.r2c_launches == before + 1
    tr, ti = RS.r2c_torch(x, radices)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL
    assert _relerr(got, np.fft.rfft(x.cpu().numpy().astype(np.float64))) \
        <= TOL


@pytest.mark.cuda
def test_k4_is_the_c2r_gradient(cuda_device):
    """The 1-D c2r's backward is one K4 launch: the weighted r2c of the
    cotangent."""
    n, B = 1024, 5
    radices = S.choose_radices(n // 2)
    c2r = RS.build_pallas_c2r({"alg": "pallas_c2r", "n": n,
                               "radices": radices}, np.float32, cuda_device)
    hr, hi = (t.requires_grad_() for t in _cuda_planes(
        cuda_device, 3, (B, n // 2 + 1)))
    g = _cuda_planes(cuda_device, 4, (B, n))[0]
    y = c2r(hr, hi)
    before = RS.r2c_launches
    y.backward(g)
    assert RS.r2c_launches == before + 1
    rr, ri = RS.r2c_cuda(g, radices, RS.device_table(
        n, tuple(radices), -1, cuda_device))
    w = RS._c2r_weights(n, cuda_device)
    assert torch.equal(hr.grad, rr * w[0]) and torch.equal(hi.grad, ri * w[1])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37, 130])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k1_wide_matches_twin_and_complex128(cuda_device, batch, sign):
    n, radices = 4096, [64, 64]
    xr, xi = _cuda_planes(cuda_device, batch, (batch, n))
    table = S.device_table(n, tuple(radices), sign, cuda_device)
    before = S.wide_launches
    kr, ki = S.stockham_c2c_cuda(xr, xi, radices, table)
    torch.cuda.synchronize()
    assert S.wide_launches == before + 1
    tr, ti = S.stockham_c2c_torch(xr, xi, radices, sign)
    got = (kr + 1j * ki).cpu().numpy()
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL
    x = xr.cpu().numpy().astype(np.float64) + 1j * xi.cpu().numpy()
    assert _relerr(got, _oracle(x, sign)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tl", [((3, 512, 40), None), ((2, 2048, 1025),
                                                             None),
                                      ((5, 32, 128), None),
                                      ((1, 512, 64), 4)])
def test_e8_inner_arm_is_the_copy(cuda_device, shape, tl):
    xr, xi = _cuda_planes(cuda_device, shape[-1], shape)
    yr, yi = copyfloor.copy_inner_cuda(xr, xi, tl)
    wr, wi = copyfloor.copy_twin(xr, xi)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 512), (5, 2048), (3, 1000)])
def test_e8_rows_arm_is_the_copy(cuda_device, shape):
    xr, xi = _cuda_planes(cuda_device, shape[0], shape)
    yr, yi = copyfloor.copy_rows_cuda(xr, xi)
    wr, wi = copyfloor.copy_twin(xr, xi)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)

