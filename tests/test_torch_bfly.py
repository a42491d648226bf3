"""The register butterfly stage of K1 and K3 (``csrc/stockham_bfly.cuh``)
and its host side in ``fftw3_tpu_torch.ops.stockham``.

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
* Every schedule the planner can hand K1, and every plane the route gate
  sends to K3, has a plan the kernels' one run-time form runs, within
  their shared memory and tiles.

Tests marked ``cuda`` run the kernels on a card (K1 over its case grid,
ragged batches, both signs, the dense fallback schedules and the four-step
options; K3 over the 2-D grid; E5's full arms) and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu.ops import pallas_stockham as PS

from fftw3_tpu_torch.ops import ablate, fused2d, matrices
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
    tab = S._kernel_table(n, radices, sign).astype(np.float64)
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
    table = torch.from_numpy(S._kernel_table(1024, [64, 16], -1))
    with pytest.raises(ValueError, match="CUDA"):
        ablate.ablate_cuda(x, x, [64, 16], table, "bfly", "full")
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
    table = S._device_table(n, tuple(radices), sign, cuda_device)
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
    table = S._device_table(q, tuple(radices), sign, cuda_device)
    w = S._device_pretwiddle(p, q, sign, cuda_device)
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
        table = fused2d._device_table_2d(n1, tuple(r1), n2, tuple(r2), sign,
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
    table = S._device_table(n, tuple(radices), -1, cuda_device)
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
