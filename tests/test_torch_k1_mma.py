"""The port's E4, E6, E9, E10, E11 and E12 (``ops/k1_mma.py``, one kernel
family in ``csrc/k1_mma.cuh``) against the reference's own kernels.

The reference's builders (``experiments/kernel_variants.py``,
``stacked_kernel.py``, ``mono_stage.py``, ``headline_gap.py``,
``presplit_g.py``, ``precision_variants.py``, loaded with ``experiments/``
on ``sys.path``) run in Pallas interpret mode on seeded numpy input; E4 and
E11 take no ``interpret`` flag, so ``jax.experimental.pallas.pallas_call``
is patched to ``functools.partial(pallas_call, interpret=True)`` for them.
Each arm's twin is held against its reference kernel on the same input:
the bf16 hi/lo arms, the diagnostic arms and E10 at r = 1 within 1e-5 of
max |y| (the kernels sum in another order); ``noxl`` within 3e-3, because
a one-ulp difference in a stage-2 input can flip its one bf16 rounding;
E10 at r = 3 and 5 within 1e-4, because the rounding compounds over r
passes of growing values.  The host constants equal the reference's bit
for bit, and the A fragments decode to their bf16 matrices under the
``mma.sync.m16n8k16`` layout.  The wrappers raise on CPU tensors and on
what the kernels do not take; tests marked ``cuda`` hold every arm against
its twin on the card.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu.ops import pallas_stockham as PS

from fftw3_tpu_torch.ops import k1_mma as K
from fftw3_tpu_torch.ops import stockham as S

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import headline_gap  # noqa: E402
import kernel_variants  # noqa: E402
import mono_stage  # noqa: E402
import precision_variants  # noqa: E402
import presplit_g  # noqa: E402
import stacked_kernel  # noqa: E402

TOL = 1e-5
F32 = np.float32
ROWS = 128
SCHEDULES = [(64, 16), (32, 32), (128, 8)]


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(F32),
            rng.standard_normal(shape).astype(F32))


def _f32(a):
    """A bf16 (ml_dtypes) or f32 array as float32."""
    return np.asarray(a).astype(F32)


def _closure(fn, name):
    """A variable a reference builder's ``run`` closes over."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.fixture
def interpret_pallas(monkeypatch):
    """``pallas_call`` in interpret mode for the builders without the
    flag (E4, E11)."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _reference(name):
    """The reference's kernel for arm `name`, as (xr, xi) -> (yr, yi)."""
    a = K.ARMS[name]
    p, q = a.radices
    if name.startswith("e4_"):
        kw = {"fsplit": a.host_split, "k2": a.groups[0] == "fused"}
        if a.diag:
            kw["diag"] = a.diag.replace("_", "-")
        return kernel_variants.make_variant(1024, [p, q], -1, 128, **kw)
    if name == "e6_stacked":
        return stacked_kernel.make_stacked(1024, [p, q], -1, 128,
                                           interpret=True)
    if name.startswith("e9_"):
        return mono_stage.make_mono(1024, [p, q], -1, 128,
                                    bf16perm=a.buffer == "bf16",
                                    interpret=True)
    if name.startswith("e10_"):
        return headline_gap.make_repeat_call(1024, [p, q], -1, 128, a.reps,
                                             interpret=True)
    if name.startswith("e11_presplit"):
        return presplit_g.make_presplit(1024, [p, q],
                                        k2stage2=a.groups[1] == "fused")
    if name == "e11_prod_k2first":
        return PS.build_pallas_c2c_split(
            {"alg": "pallas", "n": 1024, "radices": [p, q], "tile_b": 128,
             "k2": "first", "gsplit": False}, -1, F32)
    mode = "noxl" if a.groups[0] == "noxl" else \
        "blockdiag" if a.pack else "prod"
    return precision_variants.make_kernel(1024, [p, q], -1, 128, mode=mode,
                                          interpret=True)


def _tol(name):
    a = K.ARMS[name]
    if a.groups[0] == "noxl":
        return 3e-3
    return 1e-4 if a.reps > 1 else TOL


# -- host constants -----------------------------------------------------------

@pytest.mark.parametrize("p,q", SCHEDULES)
def test_g_and_its_halves_equal_stage_consts(p, q):
    """G's bf16 hi/lo and stage 1's twiddle against ``_stage_consts(...,
    presplit=True)``, both stages."""
    consts = PS._stage_consts(1024, [p, q], -1, 0, presplit=True)
    for r, st in zip((p, q), consts):
        G = torch.from_numpy(K.g_matrix(r))
        hi, lo = K.split_hi_lo(G)
        assert np.array_equal(hi.numpy(), _f32(st[0]))
        assert np.array_equal(hi.numpy(), _f32(st[1])[:, :2 * r])
        assert np.array_equal(lo.numpy(), _f32(st[1])[:, 2 * r:])
    w = K.twiddle_pairs(p)
    assert np.array_equal(w[..., 0], consts[0][2])
    assert np.array_equal(w[..., 1], consts[0][3])


@pytest.mark.parametrize("p", [64, 16])
def test_mono_ggg_equals_reference(p):
    """``mono_stage._ggg``: [Gh | Gh | Gl] with Gl unrounded f32, which the
    reference's kernel rounds to bf16: the kernel's Gh and Gl."""
    ggg = mono_stage._ggg(p, -1)
    hi, lo = K.split_hi_lo(torch.from_numpy(K.g_matrix(p)))
    m = 2 * p
    assert np.array_equal(ggg[:, :m], hi.numpy())
    assert np.array_equal(ggg[:, m:2 * m], hi.numpy())
    gl = torch.from_numpy(ggg[:, 2 * m:]).to(torch.bfloat16).float()
    assert np.array_equal(gl.numpy(), lo.numpy())
    wr, wi = mono_stage._tw_flat(64, 16, 1024, -1, 1)
    assert np.array_equal(wr, K.twiddle_pairs(64)[..., 0])
    assert np.array_equal(wi, K.twiddle_pairs(64)[..., 1])


def test_presplit_consts_equal_reference():
    consts = presplit_g._presplit_consts(1024, [64, 16], -1, 0)
    for r, st in zip((64, 16), consts):
        hi, lo = K.split_hi_lo(torch.from_numpy(K.g_matrix(r)))
        assert np.array_equal(_f32(st[0]), hi.numpy())
        assert np.array_equal(_f32(st[1]),
                              np.concatenate([hi.numpy(), lo.numpy()], 1))
    assert np.array_equal(consts[0][2], K.twiddle_pairs(64)[..., 0])


@pytest.mark.parametrize("p,q", SCHEDULES)
def test_packed_g_equals_reference_bd(p, q):
    """E12's plan-time BD from the reference builder's own constants: the
    stages with 2p < 128 packed, the others left as G."""
    run = precision_variants.make_kernel(1024, [p, q], -1, 128,
                                         mode="blockdiag", interpret=True)
    flat = _closure(run, "flat_consts")
    stage_g = [flat[0], flat[3]]          # G, wr, wi, G
    for r, g in zip((p, q), stage_g):
        want = K.packed_g(r) if K.pack_factor(r, True) > 1 else K.g_matrix(r)
        assert g.dtype == np.float32 and np.array_equal(g, want)
        assert np.signbit(g).sum() == np.signbit(want).sum()


@pytest.mark.parametrize("fsplit", [True, False])
def test_e4_constants_equal_reference(fsplit):
    """E4's per-stage constants: the ``fsplit`` triples (Fr, Fi, Fr + Fi
    hi/lo) are the Karatsuba fragment matrices; without it, Fr and Fi as
    f32, the kernel split's input."""
    run = kernel_variants.make_variant(1024, [32, 32], -1, 128,
                                       fsplit=fsplit)
    flat = _closure(run, "flat_consts")
    mats = K.fragment_mats("karatsuba", 32)   # Frh Fih Fsh Frl Fil Fsl
    if fsplit:
        st1, st2 = flat[:6], flat[8:14]
        for st in (st1, st2):
            got = [_f32(st[i]) for i in (0, 2, 4, 1, 3, 5)]
            for g, w in zip(got, mats):
                assert np.array_equal(g, w)
        wr, wi = flat[6], flat[7]
    else:
        fr, fi = K.f_planes(32)
        assert np.array_equal(flat[0], fr) and np.array_equal(flat[1], fi)
        assert np.array_equal(flat[4], fr) and np.array_equal(flat[5], fi)
        hc = K.host_consts("karatsuba", 32, False)
        assert np.array_equal(hc, np.concatenate([fr.ravel(), fi.ravel()]))
        wr, wi = flat[2], flat[3]
    assert np.array_equal(wr, K.twiddle_pairs(32)[..., 0])
    assert np.array_equal(wi, K.twiddle_pairs(32)[..., 1])


def _decode_a(words, rows, nmat):
    """Invert the A-fragment layout independently of ``mma_fragments``:
    element i of a lane's 8 bf16 sits at row gid + 8 * ((i // 2) % 2),
    column 2 * tig + i % 2 + 8 * (i // 4) of its 16 x 16 tile (PTX ISA,
    mma.m16n8k16 .bf16 A layout)."""
    T = rows // 16
    halves = words.view(np.uint16).reshape(T, T, nmat, 32, 8)
    out = np.zeros((nmat, rows, rows), np.uint16)
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for i in range(8):
            r = gid + 8 * ((i // 2) % 2)
            c = 2 * tig + i % 2 + 8 * (i // 4)
            for m in range(T):
                for k in range(T):
                    out[:, 16 * m + r, 16 * k + c] = halves[m, k, :, lane, i]
    return [torch.from_numpy(o.view(np.int16)).view(torch.bfloat16)
            .to(torch.float32).numpy() for o in out]


@pytest.mark.parametrize("form,p", [("stacked", 64), ("stacked", 16),
                                    ("stacked", 32), ("stacked", 128),
                                    ("stacked", 8), ("karatsuba", 32)])
def test_host_fragments_decode_to_bf16_matrices(form, p):
    """The host split's words decode to bf16 Fr, Fi (and Fr + Fi) hi/lo, at
    p = 8 to the stacked G's hi/lo, in the kernel's order."""
    words = K.host_consts(form, p, True).view(np.int32)
    fr, fi = (torch.from_numpy(a) for a in K.f_planes(p))
    if form == "karatsuba":
        base = [fr, fi, fr + fi]
    elif p >= 16:
        base = [fr, fi]
    else:
        base = [torch.from_numpy(K.g_matrix(p))]
    halves = [K.split_hi_lo(m) for m in base]
    want = [h for h, _ in halves] + [lo for _, lo in halves]
    got = _decode_a(words, want[0].shape[0], len(want))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# -- twins against the reference's kernels ------------------------------------

@pytest.mark.parametrize("name", sorted(K.ARMS))
def test_twin_equals_reference_kernel(name, interpret_pallas, monkeypatch):
    """Every arm's twin against its reference kernel in interpret mode, at
    (128, 1024), one tile of the reference's grid."""
    import jax
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    xr, xi = _planes((ROWS, 1024), sum(map(ord, name)))
    wr, wi = jax.jit(_reference(name))(xr, xi)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    yr, yi = K.k1_mma_torch(torch.from_numpy(xr), torch.from_numpy(xi), name)
    got = yr.numpy() + 1j * yi.numpy()
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    assert err <= _tol(name), err


@pytest.mark.parametrize("name", [n for n, a in K.ARMS.items()
                                  if a.diag is None and a.reps == 1])
def test_twin_near_float64(name):
    """Every arm but the diagnostics and E10's repeats is a forward DFT:
    within 1e-5 of float64 (noxl 3e-3), at 64 rows."""
    xr, xi = _planes((64, 1024), 5)
    yr, yi = K.k1_mma_torch(torch.from_numpy(xr), torch.from_numpy(xi), name)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=1)
    err = np.max(np.abs(yr.numpy() + 1j * yi.numpy() - ref)) \
        / np.max(np.abs(ref))
    assert err <= (3e-3 if name == "e12_noxl" else TOL), err
    if name == "e12_noxl":
        assert err > 1e-4


def test_twin_bf16_buffer_equals_f32_buffer():
    """The bf16 buffer holds the halves the f32 buffer's stage-2 split
    makes: the two E9 twins agree bit for bit."""
    xr, xi = (torch.from_numpy(a) for a in _planes((8, 1024), 9))
    a = K.k1_mma_torch(xr, xi, "e9_mono")
    b = K.k1_mma_torch(xr, xi, "e9_mono_bf16perm")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("sched", ["64x16", "32x32", "128x8"])
def test_twin_blockdiag_equals_prod_to_rounding(sched):
    xr, xi = (torch.from_numpy(a) for a in _planes((8, 1024), 10))
    pr, pi = K.k1_mma_torch(xr, xi, f"e12_prod_{sched}")
    br, bi = K.k1_mma_torch(xr, xi, f"e12_blockdiag_{sched}")
    y, z = torch.complex(pr, pi), torch.complex(br, bi)
    assert float((y - z).abs().max() / y.abs().max()) <= 1e-6


def test_twin_copy_is_the_input():
    xr, xi = (torch.from_numpy(a) for a in _planes((3, 1024), 1))
    yr, yi = K.k1_mma_torch(xr, xi, "e4_diag_copy")
    assert torch.equal(yr, xr) and torch.equal(yi, xi)
    assert yr.data_ptr() != xr.data_ptr()


# -- bounds and layout --------------------------------------------------------

@pytest.mark.parametrize("name,ms", [
    ("e6_stacked", 0.049), ("e12_prod_32x32", 0.039),
    ("e12_prod_128x8", 0.083), ("e4_baseline", 0.029),
    ("e12_blockdiag_32x32", 0.078), ("e12_blockdiag_64x16", 0.078),
    ("e12_blockdiag_128x8", 0.117), ("e12_noxl", 0.033)])
def test_tensor_core_bounds(name, ms):
    """bf16 flops a point at B = 24576 over 989 TFLOP/s: the stage counts
    24p (stacked), 18p (Karatsuba), 16p (noxl), r-fold where packed."""
    t = K.stage_flops(K.ARMS[name]) * 24576 * 1024 / 989e12 * 1e3
    assert abs(t - ms) < 0.0015, t


def test_repeat_flops_scale_with_r():
    base = K.stage_flops(K.ARMS["e10_rep1"])
    assert base == 24.0 * 64
    assert K.stage_flops(K.ARMS["e10_rep5"]) == 5 * base
    assert K.stage_flops(K.ARMS["e4_diag_copy"]) == 0.0


def test_shared_memory_fits():
    """Every arm runs at two rows-per-block values at least; [128, 8]'s 128
    KB of fragments leave it 2 and 4."""
    for name in K.ARMS:
        fit = K.rows_per_block_fit(name)
        assert len(fit) >= 2 and fit[0] == 2, name
    assert K.rows_per_block_fit("e12_prod_128x8") == [2, 4]
    assert K.smem_bytes("e6_stacked", 1) == 16 * (2048 + 128) + 4 * (
        2 * 64 * 20 + 2 * 16 * 68)
    assert K.smem_bytes("e9_mono_bf16perm", 1) == 16 * (2048 + 128) + 4 * (
        2 * 64 * 20 + 4 * 64 * 12)


def test_e11_prod_k2first_matches_default_build_on_other_grouping():
    """The reference's default build (presplit G) of k2 = "first" is the
    fused cross on both stages; the arm pins ``gsplit: False``, whose
    stage 2 runs three passes: both agree to rounding."""
    xr, xi = (torch.from_numpy(a) for a in _planes((8, 1024), 2))
    a = K.k1_mma_torch(xr, xi, "e11_prod_k2first")
    b = K.k1_mma_torch(xr, xi, "e11_presplit_k2s2")
    y, z = torch.complex(*a), torch.complex(*b)
    assert float((y - z).abs().max() / y.abs().max()) <= 1e-6
    assert PS._use_presplit()


# -- wrappers -----------------------------------------------------------------

def test_wrappers_raise_on_cpu_tensors():
    x = torch.zeros(4, 1024)
    before = dict(K.launches)
    with pytest.raises(ValueError, match="CUDA"):
        K.k1_mma_cuda(x, x, "e6_stacked")
    with pytest.raises(ValueError, match="CUDA"):
        K.k1_inplace_cuda(x, x, [32, 32], x)
    assert K.launches == before


@pytest.mark.parametrize("call,match", [
    (lambda: K.k1_mma_cuda(torch.zeros(4, 512), torch.zeros(4, 512),
                           "e6_stacked"), "1024"),
    (lambda: K.k1_mma_cuda(torch.zeros(4, 1024), torch.zeros(4, 1024),
                           "e13"), "arm"),
    (lambda: K.k1_mma_cuda(torch.zeros(4, 1024), torch.zeros(3, 1024),
                           "e6_stacked"), "1024"),
    (lambda: K.k1_mma_cuda(torch.zeros(4, 1024), torch.zeros(4, 1024),
                           "e12_prod_128x8", 8), "shared memory"),
    (lambda: K.k1_mma_torch(torch.zeros(4, 2048), torch.zeros(4, 2048),
                            "e4_baseline"), "1024"),
    (lambda: K.k1_mma_torch(torch.zeros(4, 1024), torch.zeros(4, 1024),
                            "bogus"), "arm"),
])
def test_wrappers_raise_on_what_they_do_not_take(call, match):
    """Checked before the device: the same errors on any tensor.  The
    kernel masks a ragged last group, so any row count is taken."""
    with pytest.raises(ValueError, match=match):
        call()


def test_port_imports_none_of_the_scripts():
    """ops/k1_mma.py names the scripts it replaces and imports none."""
    src = (REPO / "fftw3_tpu_torch" / "ops" / "k1_mma.py").read_text()
    for mod in ("jax", "fftw3_tpu", "experiments", "kernel_variants",
                "stacked_kernel", "mono_stage", "headline_gap",
                "presplit_g", "precision_variants"):
        assert f"import {mod}" not in src and f"from {mod}" not in src


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


#: rows that take every block of the kernel's grid through several row
#: groups at every rows per block (the grid is at most 8 blocks of 256
#: threads an SM), the last one ragged
MANY_ROWS = 3 * 8192 + 5


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K.ARMS))
def test_kernel_equals_twin_on_card(name):
    """Each arm at every rows per block against its twin, on one row, a
    ragged block, the reference's verify shape and MANY_ROWS, where every
    block walks several row groups; noxl within 1.5e-3, below what a
    kernel that split X would read from noxl's twin (about 2.5e-3)."""
    dev = _card()
    tol = 1.5e-3 if K.ARMS[name].groups[0] == "noxl" else _tol(name)
    for rows in (1, 7, 256, MANY_ROWS):
        xr, xi = (torch.from_numpy(a).to(dev)
                  for a in _planes((rows, 1024), rows))
        t = torch.complex(*K.k1_mma_torch(xr, xi, name))
        for rpb in K.rows_per_block_fit(name):
            k = torch.complex(*K.k1_mma_cuda(xr, xi, name, rpb))
            err = float((k - t).abs().max() / t.abs().max())
            assert err <= tol, (rpb, rows, err)
            if rows == MANY_ROWS:
                a = K.ARMS[name]
                grid = K._grids[a.source, a.variant, rpb, dev.index or 0]
                assert 2 * grid * rpb < rows, (rpb, grid)


@pytest.mark.cuda
def test_launches_count_each_kernel_launch():
    dev = _card()
    xr, xi = (torch.from_numpy(a).to(dev) for a in _planes((16, 1024), 3))
    before = K.launches.get("e6_stacked", 0)
    K.k1_mma_cuda(xr, xi, "e6_stacked")
    K.k1_mma_cuda(xr, xi, "e6_stacked", 2)
    assert K.launches["e6_stacked"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 4096])
def test_inplace_k1_equals_out_of_place(rows):
    """E10's donate: K1 with y = x gives K1's out-of-place result bit for
    bit."""
    dev = _card()
    xr, xi = (torch.from_numpy(a).to(dev) for a in _planes((rows, 1024), 4))
    tab = S.device_table(1024, (32, 32), -1, dev)
    wr, wi = S.stockham_c2c_cuda(xr, xi, [32, 32], tab)
    n0 = K.inplace_launches
    yr, yi = K.k1_inplace_cuda(xr, xi, [32, 32], tab)
    assert yr.data_ptr() == xr.data_ptr() and K.inplace_launches == n0 + 1
    assert torch.equal(yr, wr) and torch.equal(yi, wi)
