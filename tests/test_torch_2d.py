"""fftw3_tpu_torch.ops.fused2d (K3, c2c over both trailing axes in one pass)
against the reference.

The same numpy inputs go through ``fftw3_tpu``'s ``build_pallas_c2c_split_2d``
(Pallas in interpret mode on the CPU) and through the port's plain twin.
Errors are max-abs error over max-abs: 2e-5 between the packages, 1e-5 for
each against numpy in float64.  The kernel runs only on a card: the tests
that launch it are marked ``cuda``.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu.ops import pallas_stockham as PS

from fftw3_tpu_torch import config
from fftw3_tpu_torch.ops import fused2d
from fftw3_tpu_torch.ops import stockham as S

TOL_PKG = 2e-5
TOL_F64 = 1e-5


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(config, "kernel_mode", "on")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _oracle(xr, xi, sign):
    x = xr.astype(np.float64) + 1j * xi
    if sign < 0:
        return np.fft.fft2(x)
    return np.fft.ifft2(x) * x.shape[-1] * x.shape[-2]


@pytest.mark.parametrize("n1,n2", [(128, 128), (128, 256)])
@pytest.mark.parametrize("pre", [1, 3])
@pytest.mark.parametrize("sign", [-1, +1])
def test_twin_matches_reference(n1, n2, pre, sign):
    xr, xi = _planes(n2 + pre, (pre, n1, n2))
    ref = PS.build_pallas_c2c_split_2d(n1, n2, sign, np.float32)
    wr, wi = jax.jit(ref)(jnp.asarray(xr), jnp.asarray(xi))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    split = fused2d.build_pallas_c2c_split_2d(n1, n2, sign, np.float32,
                                              device="cpu")
    before = fused2d.launches
    yr, yi = split(torch.from_numpy(xr), torch.from_numpy(xi))
    assert fused2d.launches == before            # the twin ran
    got = yr.numpy() + 1j * yi.numpy()
    oracle = _oracle(xr, xi, sign)
    assert got.shape == want.shape == (pre, n1, n2)
    assert _relerr(got, want) <= TOL_PKG
    assert _relerr(got, oracle) <= TOL_F64
    assert _relerr(want, oracle) <= TOL_F64


def test_descriptor_pins_reach_the_twin():
    """The per-axis descriptors' schedules and ``vpu`` pin are honoured."""
    n1, n2 = 128, 256
    d1 = {"alg": "pallas", "n": n1, "radices": [16, 8], "vpu": "all"}
    d2 = {"alg": "pallas", "n": n2, "radices": [16, 16], "vpu": "all"}
    xr, xi = _planes(3, (2, n1, n2))
    ref = PS.build_pallas_c2c_split_2d(n1, n2, -1, np.float32, d1, d2)
    wr, wi = jax.jit(ref)(jnp.asarray(xr), jnp.asarray(xi))
    split = fused2d.build_pallas_c2c_split_2d(n1, n2, -1, np.float32, d1, d2,
                                              device="cpu")
    yr, yi = split(torch.from_numpy(xr), torch.from_numpy(xi))
    got = yr.numpy() + 1j * yi.numpy()
    assert _relerr(got, np.asarray(wr) + 1j * np.asarray(wi)) <= TOL_PKG
    assert _relerr(got, _oracle(xr, xi, -1)) <= TOL_F64


def test_split_grads_equal_jax_vjp():
    n1, n2 = 128, 128
    xr, xi = _planes(7, (2, n1, n2))
    gr, gi = _planes(8, (2, n1, n2))
    ref = PS.build_pallas_c2c_split_2d(n1, n2, +1, np.float32)
    _, vjp = jax.vjp(ref, jnp.asarray(xr), jnp.asarray(xi))
    wr, wi = (np.asarray(g) for g in vjp((jnp.asarray(gr), jnp.asarray(gi))))
    split = fused2d.build_pallas_c2c_split_2d(n1, n2, +1, np.float32,
                                              device="cpu")
    tr = torch.from_numpy(xr).requires_grad_()
    ti = torch.from_numpy(xi).requires_grad_()
    yr, yi = split(tr, ti)
    torch.autograd.backward([yr, yi], [torch.from_numpy(gr),
                                       torch.from_numpy(gi)])
    assert _relerr(tr.grad.numpy(), wr) <= TOL_PKG
    assert _relerr(ti.grad.numpy(), wi) <= TOL_PKG


@pytest.mark.parametrize("n1,n2,rows,tc", [(512, 512, 16, 16),
                                           (384, 768, 10, 16),
                                           (128, 2048, 4, 64),
                                           (2048, 128, 64, 4),
                                           (256, 1024, 8, 32)])
def test_tiles(n1, n2, rows, tc):
    assert fused2d.tiles(n1, n2) == (rows, tc)
    assert rows * n2 <= fused2d.TILE_POINTS
    assert n1 * tc <= fused2d.TILE_POINTS


#: the dynamic shared memory a block may opt in to on an H100 (232,448 B),
#: less K3's static shared memory: 16 levels of 64 B and two mbarriers
OPT_IN_CAP = 232448 - 16 * 64 - 2 * 8
#: 16-byte aligned addresses of K3's four tensors, and the same with the
#: first input plane 4 bytes off
ALIGNED = (1 << 20, 3 << 20, 5 << 20, 7 << 20)
MISALIGNED = (ALIGNED[0] + 4,) + ALIGNED[1:]


@pytest.mark.parametrize("n1,n2,pointers,ring", [
    # test_tiles' shapes: every one takes the ring
    (512, 512, ALIGNED, True), (384, 768, ALIGNED, True),
    (128, 2048, ALIGNED, True), (2048, 128, ALIGNED, True),
    (256, 1024, ALIGNED, True),
    # 896 = [56, 16]: a dense stage, which needs the second buffer
    (896, 128, ALIGNED, False),
    # tiles of 2 columns: no whole 16-byte pieces
    (2304, 128, ALIGNED, False),
    (512, 512, MISALIGNED, False)])
def test_ring_form_and_its_shared_memory(n1, n2, pointers, ring):
    r1, r2 = S.choose_radices(n1), S.choose_radices(n2)
    rows, tc = fused2d.tiles(n1, n2)
    p2 = S.level_plan(n2, tuple(r2), 1)
    p1 = S.level_plan(n1, tuple(r1), tc)
    assert fused2d.ring_fits(p2, p1, rows, n2, tc, pointers) is ring
    smem = fused2d.smem_2d(p2, p1, rows, ring)
    assert smem <= fused2d.MAX_SMEM <= OPT_IN_CAP
    # the ring's two buffers are the in-order form's one buffer twice
    one = fused2d.smem_2d(p2, p1, rows)
    tables = 4 * (-(-(p2[3] + p1[3]) // 4) * 4)
    assert fused2d.smem_2d(p2, p1, rows, True) - tables == \
        (2 if max(p2[1], p1[1]) == 1 else 1) * (one - tables)


def test_ring_shared_memory_at_512():
    """512 x 512: the tables (8960 B) and two buffers of two planes of
    10112 floats (16 rows at the row plan's stride 632)."""
    p2 = S.level_plan(512, (32, 16), 1)
    p1 = S.level_plan(512, (32, 16), 16)
    assert fused2d.smem_2d(p2, p1, 16) == 89856
    assert fused2d.smem_2d(p2, p1, 16, ring=True) == 170752


def test_ring_takes_the_addresses_of_the_tensors():
    """The form follows the input as it is: a view 4 bytes into its
    storage is not 16-byte aligned and takes the in-order form."""
    p2 = S.level_plan(512, (32, 16), 1)
    p1 = S.level_plan(512, (32, 16), 16)
    flat = torch.zeros(2 * 512 * 512 + 4)
    x = flat[:-4].view(2, 512, 512)
    off = flat[1:-3].view(2, 512, 512)
    ptrs = [t.data_ptr() for t in (x, x, x, x)]
    assert fused2d.ring_fits(p2, p1, 16, 512, 16, ptrs) is \
        (x.data_ptr() % 16 == 0)
    assert not fused2d.ring_fits(p2, p1, 16, 512, 16,
                                 [off.data_ptr()] + ptrs[1:])


@pytest.mark.parametrize("pointers", [ALIGNED, MISALIGNED],
                         ids=["ring", "in_order"])
@pytest.mark.parametrize("n1,n2,rad1,rad2,fixed", [
    # ESTIMATE's [32, 16] on both axes of a 512 x 512 plane
    (512, 512, None, None, True),
    # the off-plane shapes: (256, 256, 1024), and (341, 384, 512), whose
    # rows are 512 on [32, 16] but whose columns are 384
    (256, 1024, None, None, False), (384, 512, None, None, False),
    # a descriptor that pins other radices at 512, on either axis
    (512, 512, [8, 8, 8], [8, 8, 8], False),
    (512, 512, None, [8, 8, 8], False),
    # a dense stage: 448 = [32, 14] along the columns, rows as at 512
    (448, 512, None, None, False)])
def test_fixed_form_is_the_512_plans_alone(n1, n2, rad1, rad2, fixed,
                                           pointers):
    """The host runs the levels compiled into K3 exactly when both level
    plans it computed are ``FIXED_PLANS``, on the ring and in order."""
    r1 = tuple(rad1 or S.choose_radices(n1))
    r2 = tuple(rad2 or S.choose_radices(n2))
    rows, tc = fused2d.tiles(n1, n2)
    p2, p1 = S.level_plan(n2, r2, 1), S.level_plan(n1, r1, tc)
    assert fused2d.fixed_fits(p2, p1) is fixed
    ring = fused2d.ring_fits(p2, p1, rows, n2, tc, pointers)
    assert ring is (pointers == ALIGNED and p1[1] == 1)


def _kernel_ints(name):
    """The int array ``plan`` of struct `name` in csrc/c2c_2d.cu."""
    src = (Path(fused2d.__file__).parents[1] / "csrc" / "c2c_2d.cu"
           ).read_text()
    got = re.search(r"struct %s \{\s*static constexpr int tl = (\d+);\s*"
                    r"static constexpr int plan\[\] = \{([^}]*)\};" % name,
                    src)
    assert got, name
    return int(got.group(1)), tuple(int(v) for v in got.group(2).split(","))


def test_fixed_plans_are_the_hosts_and_the_kernels():
    """``FIXED_PLANS`` are the host's level plans of a 512 x 512 plane on
    ESTIMATE's schedule, and the kernel's compiled-in ``FixedRows`` and
    ``FixedCols``: a change to ``level_plan`` shows here, and the host
    stops asking for the compiled-in form rather than run stale
    constants."""
    rad = tuple(S.choose_radices(512))
    assert rad == (32, 16)
    rows, tc = fused2d.tiles(512, 512)
    assert (rows, tc) == (16, 16)
    assert fused2d.FIXED_PLANS == (S.level_plan(512, rad, 1),
                                   S.level_plan(512, rad, tc))
    assert _kernel_ints("FixedRows") == (1, fused2d.FIXED_PLANS[0])
    assert _kernel_ints("FixedCols") == (tc, fused2d.FIXED_PLANS[1])
    src = (Path(fused2d.__file__).parents[1] / "csrc" / "c2c_2d.cu"
           ).read_text()
    assert re.search(r"constexpr int kFixedN = 512, kFixedChunk = %d;"
                     % rows, src)


def test_max_smem_is_the_kernels():
    """``MAX_SMEM`` is ``kMaxSmem`` of csrc/c2c_2d.cu."""
    src = (Path(fused2d.__file__).parents[1] / "csrc" / "c2c_2d.cu"
           ).read_text()
    got = re.search(r"constexpr int kMaxSmem = (\d+);", src)
    assert got and int(got.group(1)) == fused2d.MAX_SMEM


@pytest.mark.parametrize("n1,n2,ok", [(128, 128, True), (384, 768, True),
                                      (512, 512, True), (512, 1024, False),
                                      (128, 130, False), (64, 128, False)])
def test_applicable_2d_equals_reference(n1, n2, ok):
    assert S.applicable_2d(n1, n2, np.float32, "cpu") is ok
    assert PS.applicable_2d(n1, n2, np.float32) is ok
    assert S.MAX_2D_POINTS == PS.MAX_2D_POINTS


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.ones(1, 128, 128)
    table = fused2d.device_table_2d(128, (128,), 128, (128,), -1,
                                    torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        fused2d.c2c_2d_cuda(x, x, [128], [128], table)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,rad1,rad2", [
    (128, 128, [128], [128]), (256, 1024, [256], [64, 16]),
    (512, 512, [32, 16], [32, 16]), (384, 768, [24, 16], [48, 16])])
@pytest.mark.parametrize("pre", [1, 3, 40])
@pytest.mark.parametrize("sign", [-1, +1])
def test_kernel_matches_twin_on_card(cuda_device, n1, n2, rad1, rad2, pre,
                                     sign):
    xr, xi = (torch.from_numpy(a).to(cuda_device)
              for a in _planes(n1 + pre, (pre, n1, n2)))
    table = fused2d.device_table_2d(n1, tuple(rad1), n2, tuple(rad2), sign,
                                    cuda_device)
    before = fused2d.launches, fused2d.ring_launches
    kr, ki = fused2d.c2c_2d_cuda(xr, xi, rad1, rad2, table)
    torch.cuda.synchronize()
    # every shape here takes the ring (test_ring_form_and_its_shared_memory)
    assert (fused2d.launches, fused2d.ring_launches) == \
        (before[0] + 1, before[1] + 1)
    tr, ti = fused2d.c2c_2d_torch(xr, xi, rad1, rad2, sign)
    got = (kr + 1j * ki).cpu().numpy()
    twin = (tr + 1j * ti).cpu().numpy()
    assert _relerr(got, twin) <= TOL_F64
    assert _relerr(got, _oracle(xr.cpu().numpy(), xi.cpu().numpy(),
                                sign)) <= TOL_F64


def _off_by_4(t):
    """A copy of `t` in a view 4 bytes into its storage: not 16-byte
    aligned, so K3 takes the in-order form."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = flat[1:].view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == 4
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("pre,n1,n2", [
    (1, 512, 512), (3, 512, 512), (40, 512, 512), (64, 512, 512),
    (3, 256, 1024), (3, 384, 768)])
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("cout", [False, True])
def test_ring_is_the_in_order_form_bit_for_bit(cuda_device, pre, n1, n2,
                                               sign, cout):
    """The ring and the in-order form give the same output bit for bit,
    in both layouts; 40 and 64 planes are more than the clusters resident
    at 512 x 512, so the ring crosses planes.  The in-order form is reached
    through a misaligned input, and only the ring's launches are counted
    as such."""
    r1, r2 = S.choose_radices(n1), S.choose_radices(n2)
    xr, xi = (torch.from_numpy(a).to(cuda_device)
              for a in _planes(n1 + n2 + pre, (pre, n1, n2)))
    table = fused2d.device_table_2d(n1, tuple(r1), n2, tuple(r2), sign,
                                    cuda_device)
    before = fused2d.launches, fused2d.ring_launches
    ring = fused2d.c2c_2d_cuda(xr, xi, r1, r2, table, complex_out=cout)
    in_order = fused2d.c2c_2d_cuda(_off_by_4(xr), _off_by_4(xi), r1, r2,
                                   table, complex_out=cout)
    torch.cuda.synchronize()
    assert (fused2d.launches, fused2d.ring_launches) == \
        (before[0] + 2, before[1] + 1)
    if cout:
        assert torch.equal(ring, in_order)
        planes = fused2d.c2c_2d_cuda(xr, xi, r1, r2, table)
        assert torch.equal(ring, torch.complex(*planes))
    else:
        assert torch.equal(ring[0], in_order[0])
        assert torch.equal(ring[1], in_order[1])
        got = (ring[0] + 1j * ring[1]).cpu().numpy()
        assert _relerr(got, _oracle(xr.cpu().numpy(), xi.cpu().numpy(),
                                    sign)) <= TOL_F64


@pytest.mark.cuda
@pytest.mark.parametrize("pre", [2, 64])
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("cout", [False, True])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "in_order"])
def test_fixed_is_the_run_time_form_bit_for_bit(cuda_device, monkeypatch,
                                                pre, sign, cout, ring):
    """On 512 x 512 planes the levels compiled into K3 give the run-time
    form's output bit for bit, on the ring and in order (a misaligned
    input), in both layouts, and match the twin; ``fixed_launches`` and
    ``ring_launches`` count one a launch.  The run-time form is reached by
    the host asking for it (``c2c_2d_launch``'s ``fixed`` 0)."""
    n, rad = 512, S.choose_radices(512)
    xr, xi = (torch.from_numpy(a).to(cuda_device)
              for a in _planes(pre + sign + 5 * cout, (pre, n, n)))
    if not ring:
        xr, xi = _off_by_4(xr), _off_by_4(xi)
    table = fused2d.device_table_2d(n, tuple(rad), n, tuple(rad), sign,
                                    cuda_device)
    counts = (fused2d.launches, fused2d.ring_launches,
              fused2d.fixed_launches)
    fixed = fused2d.c2c_2d_cuda(xr, xi, rad, rad, table, complex_out=cout)
    torch.cuda.synchronize()
    assert (fused2d.launches, fused2d.ring_launches,
            fused2d.fixed_launches) == \
        (counts[0] + 1, counts[1] + ring, counts[2] + 1)
    monkeypatch.setattr(fused2d, "fixed_fits", lambda p2, p1: False)
    run_time = fused2d.c2c_2d_cuda(xr, xi, rad, rad, table,
                                   complex_out=cout)
    torch.cuda.synchronize()
    assert (fused2d.launches, fused2d.ring_launches,
            fused2d.fixed_launches) == \
        (counts[0] + 2, counts[1] + 2 * ring, counts[2] + 1)
    if cout:
        assert torch.equal(fixed, run_time)
        got = fixed.cpu().numpy()
    else:
        assert torch.equal(fixed[0], run_time[0])
        assert torch.equal(fixed[1], run_time[1])
        got = (fixed[0] + 1j * fixed[1]).cpu().numpy()
    tr, ti = fused2d.c2c_2d_torch(xr, xi, rad, rad, sign)
    assert _relerr(got, (tr + 1j * ti).cpu().numpy()) <= TOL_F64
