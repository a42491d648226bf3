"""The port's measurement kernels E1, E2, E3 and E7 against the reference's
own kernel bodies.

Each twin gets the same seeded numpy input as the reference's body
(``experiments/copy1000.py``, ``bisect4096.py``, ``bisect4096b.py``,
``race4096.py``; the bodies called on numpy arrays as refs, one (tb, n)
block at a time as the reference's grid hands them out, the E7 kernel in
Pallas interpret mode): E1 and E7 bit for bit, E2 and E3 within 1e-5 of
max |y| (different summation orders; the bf16 arms against the reference's
own bf16 output, not float64).  The ``pallas4`` arms of E7's block 1 are
held against the reference's four-step in interpret mode at n = 4096
within 2e-5, and pinned by reference-format wisdom.  The host constants
equal the reference's bit for bit, and the tensor-core fragments decode
to bf16(F) under the ``mma.sync.m16n8k16`` layout.  The wrappers raise on
CPU tensors; tests marked ``cuda`` hold each kernel against its twin on
the card.  The port imports none of JAX, the reference or the scripts.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import pallas_stockham as PS

import fftw3_tpu_torch as ft
from fftw3_tpu_torch import config, planner
from fftw3_tpu_torch.ops import c2c, stage4096, swap, unaligned

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "experiments"))
import bisect4096  # noqa: E402
import bisect4096b  # noqa: E402
import copy1000  # noqa: E402
import race4096  # noqa: E402

TOL = 1e-5
F32 = np.float32


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(F32),
            rng.standard_normal(shape).astype(F32))


def _blocks(body, rows, tb, n, *arrays):
    """Run a reference body over (tb, n) blocks as its grid does; returns
    the two output planes (one for a one-plane body)."""
    outs = [np.zeros((rows, n), F32) for _ in range(2)]
    for i in range(0, rows, tb):
        blk = [a[i:i + tb] for a in arrays]
        body(*blk, *[o[i:i + tb] for o in outs])
    return outs


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- E1 ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("body", ["_copy_kernel", "_trans_kernel"])
def test_e1_twin_equals_reference_body(body, n):
    x, _ = _planes((copy1000.TB, n), n)
    y = np.zeros_like(x)
    getattr(copy1000, body)(x, y)
    got = unaligned.unaligned_torch(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, y)


@pytest.mark.parametrize("n", [1000, 1024])
def test_e1_batch_is_the_references(n):
    want = max(copy1000.TB,
               int(round(copy1000.POINTS / n / copy1000.TB)) * copy1000.TB)
    assert unaligned.batch(n) == want == {1000: 16640, 1024: 16256}[n]
    assert unaligned.POINTS == copy1000.POINTS


def test_e1_trans_tile_fits():
    for n in (1000, 1024):
        e = unaligned.TRANS_ROWS * n
        assert unaligned.trans_smem(n) == 4 * (e + (e - 1) // 32 + 1)
        assert unaligned.trans_smem(n) <= 98304


# -- E2 and E3 ----------------------------------------------------------------

@pytest.mark.parametrize("n", [4096, 2048])
def test_e2_host_constants_equal_reference(n):
    p = stage4096.CASES[n]
    assert np.array_equal(stage4096.g_matrix(p), bisect4096.gmat(p))
    wr, wi = bisect4096.twid(n, p)
    mine = stage4096.twiddle(n)
    assert np.array_equal(mine[0], wr) and np.array_equal(mine[1], wi)
    G, Gh, Gl = bisect4096b.gmats(p)
    hi, lo = stage4096.split_hi_lo(torch.from_numpy(G))
    assert np.array_equal(hi.numpy(), Gh.astype(F32))
    assert np.array_equal(lo.numpy(), Gl.astype(F32))


E2_BODIES = {
    "identity": lambda n, tb, p: bisect4096.k_identity,
    "roundtrip": lambda n, tb, p: bisect4096.k_transpose,
    "stage1_f32": lambda n, tb, p: (
        lambda xr, xi, yr, yi: bisect4096.k_stage1(
            n, tb, p, xr, xi, bisect4096.gmat(p), yr, yi)),
    "stage1_tw_perm": lambda n, tb, p: (
        lambda xr, xi, yr, yi: bisect4096.k_stage1_tw_perm(
            n, tb, p, xr, xi, bisect4096.gmat(p), *bisect4096.twid(n, p),
            yr, yi)),
}


@pytest.mark.parametrize("n", [4096, 2048])
@pytest.mark.parametrize("arm", list(E2_BODIES))
def test_e2_twin_equals_reference_body(arm, n):
    """At (64, 4096) and the (64, 2048) control, tb = 32."""
    tb, p = 32, stage4096.CASES[n]
    xr, xi = _planes((2 * tb, n), n + len(arm))
    wr, wi = _blocks(E2_BODIES[arm](n, tb, p), 2 * tb, tb, n, xr, xi)
    yr, yi = stage4096.stage_torch(torch.from_numpy(xr),
                                   torch.from_numpy(xi), arm)
    got = yr.numpy() + 1j * yi.numpy()
    want = wr + 1j * wi
    if arm in ("identity", "roundtrip"):
        assert np.array_equal(got, want)
    else:
        assert _rel(got, want) <= TOL


E3_ARMS = {"highest": "stage1_f32", "ps": "stage1_ps", "bf16": "stage1_bf16"}


@pytest.mark.parametrize("mm", list(E3_ARMS))
@pytest.mark.parametrize("n,tb,p", [(2048, 128, 128), (2048, 32, 128),
                                    (4096, 128, 64), (4096, 32, 64)])
def test_e3_twin_equals_reference_body(n, tb, p, mm):
    """bisect4096b's cases (every (n, tb, p) it runs) in all three modes;
    the bf16 forms against the reference's own bf16 output."""
    G, Gh, Gl = bisect4096b.gmats(p)
    consts = {"highest": (G,), "ps": (Gh, Gl), "bf16": (Gh,)}[mm]
    xr, xi = _planes((2 * tb, n), n + tb)

    def body(a, b, yr, yi):
        bisect4096b.k_stage1(n, tb, p, mm, a, b, *consts, yr, yi)
    wr, wi = _blocks(body, 2 * tb, tb, n, xr, xi)
    yr, yi = stage4096.stage_torch(torch.from_numpy(xr),
                                   torch.from_numpy(xi), E3_ARMS[mm])
    assert _rel(yr.numpy() + 1j * yi.numpy(), wr + 1j * wi) <= TOL


@pytest.mark.parametrize("n", [4096, 2048])
def test_e3_bf16_arm_sits_near_2e3(n):
    """The one-pass bf16 arm is a measurement arm: about 2e-3 from
    float64, where the ps arm and the f32 arm are within 1e-5."""
    xr, xi = _planes((8, n), 7)
    p = stage4096.CASES[n]
    x = (xr.astype(np.float64) + 1j * xi).reshape(8, p, n // p)
    want = np.einsum("kj,bjq->bkq", np.fft.fft(np.eye(p), axis=0),
                     x).reshape(8, n)
    errs = {}
    for arm in ("stage1_f32", "stage1_ps", "stage1_bf16"):
        yr, yi = stage4096.stage_torch(torch.from_numpy(xr),
                                       torch.from_numpy(xi), arm)
        errs[arm] = _rel(yr.numpy() + 1j * yi.numpy(), want)
    assert errs["stage1_f32"] <= TOL and errs["stage1_ps"] <= TOL
    assert 1e-4 < errs["stage1_bf16"] < 1e-2


def _decode_a(words, p, nmat):
    """Invert the A-fragment layout independently of ``mma_fragments``:
    element i of a lane's 8 bf16 sits at row gid + 8 * ((i // 2) % 2),
    column 2 * tig + i % 2 + 8 * (i // 4) of its 16 x 16 tile (PTX ISA,
    mma.m16n8k16 .bf16 A layout)."""
    T = p // 16
    halves = words.view(np.uint16).reshape(T, T, nmat, 32, 8)
    out = np.zeros((nmat, p, p), np.uint16)
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


@pytest.mark.parametrize("p", [64, 128])
def test_e3_fragments_decode_to_bf16_f(p):
    fr, fi = stage4096.f_planes(p)
    hr, lr = stage4096.split_hi_lo(torch.from_numpy(fr))
    hi, li = stage4096.split_hi_lo(torch.from_numpy(fi))
    ps = stage4096._host_consts("stage1_ps", p).view(np.int32)
    got = _decode_a(ps, p, 4)
    for g, w in zip(got, (hr, hi, lr, li)):
        assert np.array_equal(g, w.numpy())
    one = stage4096._host_consts("stage1_bf16", p).view(np.int32)
    got = _decode_a(one, p, 2)
    assert np.array_equal(got[0], hr.numpy())
    assert np.array_equal(got[1], hi.numpy())


def test_e2_shared_memory_fits():
    """Every arm runs at one rows-per-block value at least; the sizes
    follow the kernel's formula."""
    for n in (4096, 2048):
        p, q = stage4096.CASES[n], n // stage4096.CASES[n]
        for arm in stage4096.ARMS:
            fit = stage4096.rows_per_block_fit(arm, n)
            assert fit and fit[0] == 1
            assert stage4096.smem_bytes(arm, n, 1) >= 8 * p * (q + 4)
    assert stage4096.rows_per_block_fit("roundtrip", 4096) == [1, 2]
    assert stage4096.rows_per_block_fit("stage1_ps", 2048) == [1, 2, 4]


def test_e2_twin_refuses_other_shapes():
    x = torch.zeros(4, 1024)
    with pytest.raises(ValueError, match="n in"):
        stage4096.stage_torch(x, x, "identity")
    y = torch.zeros(4, 4096)
    with pytest.raises(ValueError, match="arm"):
        stage4096.stage_torch(y, y, "stage2")


# -- E7 ----------------------------------------------------------------------

def test_e7_twin_equals_reference_kernel():
    """race4096.make_pallas_transpose(32, 128, g=32) in interpret mode, bit
    for bit, on 64 matrices."""
    import jax.numpy as jnp
    xr, xi = _planes((64, swap.P, swap.Q), 3)
    run = race4096.make_pallas_transpose(swap.P, swap.Q, 32, interpret=True)
    wr, wi = run(jnp.asarray(xr), jnp.asarray(xi))
    yr, yi = swap.swap_torch(torch.from_numpy(xr), torch.from_numpy(xi))
    assert yr.shape == (64, swap.Q, swap.P)
    assert np.array_equal(yr.numpy(), np.asarray(wr))
    assert np.array_equal(yi.numpy(), np.asarray(wi))


ARMS4 = {**swap.FOURSTEP_ARMS,
         **{f"{k} fused": swap.fused(d)
            for k, d in swap.FOURSTEP_ARMS.items()}}


@pytest.mark.parametrize("arm", list(ARMS4))
def test_e7_fourstep_arms_equal_reference(arm, monkeypatch):
    """Each block-1 arm on the port (twins on the CPU) against the
    reference's four-step in interpret mode at n = 4096, 16 rows."""
    import jax
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    desc = ARMS4[arm]
    xr, xi = _planes((16, 4096), 11)
    ref = PS.build_pallas_c2c_split_fourstep(desc, -1, F32)
    wr, wi = jax.jit(ref)(xr, xi)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    mine = c2c.build_c2c_split(desc, -1, F32, "cpu")
    yr, yi = mine(torch.from_numpy(xr), torch.from_numpy(xi))
    assert _rel(yr.numpy() + 1j * yi.numpy(), want) <= 2e-5


def _c2c_wisdom(desc, batch):
    sig = "cpu-cpu-jax0.9.0-jl0.9.0-pvd9747e2d"
    key = f"c2c:{desc['n']}:float32:{sig}:b{planner._batch_bucket(batch)}"
    return json.dumps({"format": planner.REFERENCE_WISDOM_FORMAT,
                       "signature": sig,
                       "entries": {key: {"desc": desc, "patience": 99,
                                         "cost": 0.0}}})


@pytest.mark.parametrize("arm", list(ARMS4))
def test_e7_fourstep_arms_pin_by_reference_wisdom(arm, monkeypatch):
    """A reference-format wisdom entry pins plan_many_dft([4096],
    howmany=2048) to each arm, the fused-store key included; the plan's
    fused-store rule reads it."""
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ft.the_planner, "wisdom", {})
    desc = ARMS4[arm]
    assert ft.import_reference_wisdom(_c2c_wisdom(desc, swap.BATCH),
                                      device="cpu")
    plan = ft.plan_many_dft([4096], howmany=swap.BATCH, device="cpu")
    assert plan.descriptors == {1: desc}
    ref = ref_planner.Planner()
    assert ref.import_wisdom(_c2c_wisdom(desc, swap.BATCH))


# -- wrappers ----------------------------------------------------------------

def test_wrappers_raise_on_cpu_tensors():
    x = torch.zeros(16, 1000)
    with pytest.raises(ValueError, match="CUDA"):
        unaligned.unaligned_cuda(x, "copy")
    y = torch.zeros(4, 4096)
    with pytest.raises(ValueError, match="CUDA"):
        stage4096.stage_cuda(y, y, "stage1_ps")
    z = torch.zeros(8, 32, 128)
    with pytest.raises(ValueError, match="CUDA"):
        swap.swap_cuda(z, z)


@pytest.mark.parametrize("call,match", [
    (lambda: unaligned.unaligned_cuda(torch.zeros(4, 1000), "bogus"),
     "arm"),
    (lambda: stage4096.stage_cuda(torch.zeros(4, 1024), torch.zeros(4, 1024),
                                  "identity"), "n in"),
    (lambda: stage4096.stage_cuda(torch.zeros(4, 4096), torch.zeros(4, 4096),
                                  "stage2"), "arm"),
    (lambda: stage4096.stage_cuda(torch.zeros(4, 4096), torch.zeros(4, 4096),
                                  "roundtrip", 4), "shared memory"),
    (lambda: swap.swap_cuda(torch.zeros(8, 32, 6), torch.zeros(8, 32, 6)),
     "q % 4"),
    (lambda: swap.swap_cuda(torch.zeros(8, 512, 128),
                            torch.zeros(8, 512, 128)), "q % 4"),
])
def test_wrappers_raise_on_shapes_they_do_not_take(call, match):
    """Checked before the device: the same errors on any tensor."""
    with pytest.raises(ValueError, match=match):
        call()


def test_port_imports_no_reference():
    """No module of the port and not chip_smoke.py imports JAX, the
    reference package or the measurement scripts: by their sources, and by
    importing every module with ``sys.modules`` checked after."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|fftw3_tpu|experiments)"
                     r"(\.|\s|$)", re.M)
    files = sorted((REPO / "fftw3_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        assert not pat.search(f.read_text()), f
    code = ("import sys, pkgutil, importlib, fftw3_tpu_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(fftw3_tpu_torch.__path__, "
            "'fftw3_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'fftw3_tpu', 'experiments', 'bisect4096', 'copy1000',"
            " 'race4096', '_race')]\n"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1024])
@pytest.mark.parametrize("arm", list(unaligned.ARMS))
def test_e1_kernel_equals_twin_on_card(arm, n):
    dev = _card()
    for rows in (1, 37, 512):
        x, _ = _planes((rows, n), rows)
        xt = torch.from_numpy(x).to(dev)
        y = unaligned.unaligned_cuda(xt, arm)
        assert torch.equal(y, unaligned.unaligned_torch(xt))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 2048])
@pytest.mark.parametrize("arm", list(stage4096.ARMS))
def test_e2_e3_kernel_equals_twin_on_card(arm, n):
    dev = _card()
    for rpb in stage4096.rows_per_block_fit(arm, n):
        for rows in (1, 7, 64):
            xr, xi = (torch.from_numpy(a).to(dev)
                      for a in _planes((rows, n), rows))
            kr, ki = stage4096.stage_cuda(xr, xi, arm, rpb)
            tr, ti = stage4096.stage_torch(xr, xi, arm)
            k, t = torch.complex(kr, ki), torch.complex(tr, ti)
            assert float((k - t).abs().max() / t.abs().max()) <= TOL, rpb


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 32, 128), (5, 8, 512),
                                   (3, 16, 256)])
def test_e7_kernel_equals_twin_on_card(shape):
    dev = _card()
    xr, xi = (torch.from_numpy(a).to(dev) for a in _planes(shape, 5))
    kr, ki = swap.swap_cuda(xr, xi)
    tr, ti = swap.swap_torch(xr, xi)
    assert torch.equal(kr, tr) and torch.equal(ki, ti)
