"""The port's dense products at full precision under any matmul setting.

The reference pins ``precision=HIGHEST`` on every dense product; the port
runs each float32 product through ``ops/dense.py`` (``exact_matmul``,
``full_precision``), which pins the process's setting for the call and
restores it, and pins the two products of its backward as well.  Here: the
pin restores every precision flag it touched, under the legacy spelling
(``set_float32_matmul_precision``, ``allow_tf32``) and the new one
(``fp32_precision``), also when the product raises, when pins nest and
when threads pin at once; ``exact_matmul``'s gradient equals
``torch.matmul``'s in float64 over broadcast shapes; under ``"high"`` the
c2c and r2r candidate lists equal the reference's; under ``"medium"``
(bf16 products on a CPU with AMX, TF32 and bf16 on the card) the five
dense solvers and their gradients stay within 1e-5 of float64 and the
gradients within 1e-5 of ``jax.grad`` through the reference's solver
(max-abs error over max-abs).  Tests marked ``cuda`` hold the solvers to
float64 under ``"high"`` on the card.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import c2c as ref_c2c
from fftw3_tpu.ops import matrices as ref_matrices
from fftw3_tpu.ops import r2r as ref_r2r
from fftw3_tpu.ops import real as ref_real

from fftw3_tpu_torch import config, kinds, planner
from fftw3_tpu_torch.ops import c2c, dense, r2r, real

TOL = 1e-5
F32 = np.float32
_B = torch.backends

#: every getter of the precision setting, legacy and new
_GETTERS = {
    "get_float32_matmul_precision": torch.get_float32_matmul_precision,
    "cuda.matmul.allow_tf32": lambda: _B.cuda.matmul.allow_tf32,
    "fp32_precision": lambda: _B.fp32_precision,
    "cuda.matmul.fp32_precision": lambda: _B.cuda.matmul.fp32_precision,
    "mkldnn.matmul.fp32_precision":
        lambda: _B.mkldnn.matmul.fp32_precision,
}

#: settings a process may have made before calling the port
SETUPS = {
    "untouched": lambda: None,
    "legacy high": lambda: torch.set_float32_matmul_precision("high"),
    "legacy medium": lambda: torch.set_float32_matmul_precision("medium"),
    "legacy allow_tf32": lambda: setattr(_B.cuda.matmul, "allow_tf32", True),
    "new cuda tf32": lambda: setattr(_B.cuda.matmul, "fp32_precision",
                                     "tf32"),
    "new mkldnn bf16": lambda: setattr(_B.mkldnn.matmul, "fp32_precision",
                                       "bf16"),
    "new global tf32": lambda: setattr(_B, "fp32_precision", "tf32"),
    "legacy then new": lambda: (
        torch.set_float32_matmul_precision("high"),
        setattr(_B.cuda.matmul, "fp32_precision", "ieee")),
}


def _state():
    out = {}
    for name, get in _GETTERS.items():
        try:
            out[name] = get()
        except (RuntimeError, AttributeError) as exc:
            out[name] = f"raises {type(exc).__name__}"
    return out


@pytest.fixture(autouse=True)
def _pristine():
    """Every test starts and ends with the process's default setting."""
    def reset():
        torch.set_float32_matmul_precision("highest")
        if hasattr(_B, "fp32_precision"):
            _B.fp32_precision = "none"
            _B.cuda.matmul.fp32_precision = "none"
            _B.mkldnn.matmul.fp32_precision = "none"
    reset()
    start = _state()
    yield
    reset()
    assert _state() == start


needs_new_api = pytest.mark.skipif(
    not hasattr(torch.backends.cuda.matmul, "fp32_precision"),
    reason="PyTorch without fp32_precision (before 2.9)")


@needs_new_api
@pytest.mark.parametrize("raises", [False, True])
@pytest.mark.parametrize("setup", list(SETUPS))
def test_pin_restores_every_flag(setup, raises):
    SETUPS[setup]()
    before = _state()
    a = torch.ones(4, 5)
    b = torch.ones(5, 3) if not raises else torch.ones(4, 3)
    inside = {}

    def product():
        with dense.full_precision():
            inside.update(_state())
            return torch.matmul(a, b)
    if raises:
        with pytest.raises(RuntimeError):
            product()
        with pytest.raises(RuntimeError):
            dense.exact_matmul(a, b)
    else:
        assert torch.equal(product(), torch.full((4, 3), 5.0))
        assert torch.equal(dense.exact_matmul(a, b), product())
    assert inside["cuda.matmul.fp32_precision"] == "ieee"
    assert inside["mkldnn.matmul.fp32_precision"] == "ieee"
    assert _state() == before


def test_pin_restores_on_legacy_pytorch(monkeypatch):
    """Without ``fp32_precision`` the pin saves and restores the legacy
    setting, also when the product raises."""
    monkeypatch.setattr(dense, "_precision_backends", lambda: None)
    torch.set_float32_matmul_precision("medium")
    seen = []
    with pytest.raises(ValueError):
        with dense.full_precision():
            seen.append(torch.get_float32_matmul_precision())
            raise ValueError("product failed")
    assert seen == ["highest"]
    assert torch.get_float32_matmul_precision() == "medium"
    assert _B.cuda.matmul.allow_tf32


@needs_new_api
def test_nested_pins_restore_on_the_last_exit():
    torch.set_float32_matmul_precision("high")
    with dense.full_precision():
        with dense.full_precision():
            pass
        assert _B.cuda.matmul.fp32_precision == "ieee"
        assert _B.mkldnn.matmul.fp32_precision == "ieee"
    assert torch.get_float32_matmul_precision() == "high"
    assert _B.cuda.matmul.fp32_precision == "tf32"


@pytest.mark.parametrize("setting", ["medium", "high"])
def test_threads_pinning_at_once(setting):
    """Eight threads making pinned products at once: every product stays
    within 1e-5 of float64 and the setting reads back unchanged."""
    torch.set_float32_matmul_precision(setting)
    before = _state()
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(F32))
    b = torch.from_numpy(rng.standard_normal((256, 256)).astype(F32))
    want = a.double() @ b.double()
    start = threading.Barrier(8)
    errs, failures = [], []

    def work():
        try:
            start.wait()
            for _ in range(20):
                y = dense.exact_matmul(a, b).double()
                errs.append(float((y - want).abs().max()
                                  / want.abs().max()))
        except BaseException as exc:       # reported after the join
            failures.append(exc)
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures
    assert len(errs) == 160 and max(errs) <= TOL
    assert _state() == before
    assert dense._depth == 0


@pytest.mark.parametrize("shapes", [
    ((5, 7), (7, 3)), ((4, 5, 7), (7, 3)), ((5, 7), (4, 7, 3)),
    ((2, 1, 5, 7), (3, 7, 4)), ((7,), (7, 3)), ((4, 5, 7), (7,))])
def test_exact_matmul_grads_equal_matmul(shapes):
    """In float64 (no reduced precision to differ by) exact_matmul's
    forward, gradients and double backward equal torch.matmul's over
    broadcast and 1-D operands."""
    rng = np.random.default_rng(len(shapes[0]) + 10 * len(shapes[1]))
    ops = [torch.from_numpy(rng.standard_normal(s)).requires_grad_()
           for s in shapes]
    y = dense.exact_matmul(*ops)
    want = torch.matmul(*ops)
    assert torch.allclose(y, want, rtol=1e-12, atol=1e-12)
    g = torch.from_numpy(rng.standard_normal(tuple(want.shape)))
    got = torch.autograd.grad(y, ops, g, create_graph=True)
    ref = torch.autograd.grad(want, ops, g, create_graph=True)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
    got2 = torch.autograd.grad(sum((t * t).sum() for t in got), ops)
    ref2 = torch.autograd.grad(sum((t * t).sum() for t in ref), ops)
    for a, b in zip(got2, ref2):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def _ref_hw():
    return planner.HardwareModel(**dataclasses.asdict(ref_planner.HW))


def _first(self, kind, n, rdtype, cands, *a, **k):
    return cands[0], 0.0


@pytest.mark.parametrize("patience", [0, kinds.PATIENCE_MEASURE])
@pytest.mark.parametrize("problem", [
    ("c2c", 16), ("c2c", 60), ("c2c", 256), ("c2c", 1024),
    ("redft10", 16), ("redft10", 512), ("dht", 17), ("redft00", 17),
    ("rodft11", 64), ("r2hc", 96)])
def test_candidates_equal_reference_under_high(problem, patience,
                                               monkeypatch):
    """Under ``set_float32_matmul_precision("high")`` the port's candidate
    lists (children planned at the same patience, MEASURE's timing stubbed
    out in both packages, kernels on in both) equal the reference's, dense
    solvers included."""
    kind, n = problem
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(ref_config, "pallas_mode", "interpret")
    monkeypatch.setattr(planner.Planner, "_measure_best", _first)
    monkeypatch.setattr(ref_planner.Planner, "_measure_best", _first)
    torch.set_float32_matmul_precision("high")
    mine, ref = planner.Planner(_ref_hw()), ref_planner.Planner()
    want = ref._candidates(kind, n, F32, patience, 64)
    got = mine._candidates(kind, n, F32, patience, 64, torch.device("cpu"))
    assert got == want
    if kind != "c2c":
        assert got[-1] == {"alg": "r2r_matmul", "kind": kind, "n": n}
    assert torch.get_float32_matmul_precision() == "high"


#: the five dense solvers: (family, descriptor)
SOLVERS = {
    "direct": ("c2c", {"alg": "direct", "n": 64}),
    "mixed": ("c2c", {"alg": "mixed", "n": 256, "p": 16,
                      "child": {"alg": "direct", "n": 16}}),
    "r2c_dense": ("r2c", {"alg": "r2c_dense", "n": 96}),
    "c2r_dense": ("c2r", {"alg": "c2r_dense", "n": 96}),
    "r2r_matmul": ("r2r", {"alg": "r2r_matmul", "kind": "redft10",
                           "n": 512}),
}


def _solver_err(name, device, rows=64):
    """Max-abs error over max-abs of solver `name` on `device` against
    float64, on seeded inputs."""
    family, desc = SOLVERS[name]
    n = desc["n"]
    rng = np.random.default_rng(n)
    xr = rng.standard_normal((rows, n)).astype(F32)
    xi = rng.standard_normal((rows, n)).astype(F32)
    t = (lambda a: torch.from_numpy(a).to(device))
    if family == "c2c":
        yr, yi = c2c.build_c2c_split(desc, -1, F32, device)(t(xr), t(xi))
        got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
        want = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
    elif family == "r2c":
        yr, yi = real.build_r2c_split(desc, F32, device)(t(xr))
        got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
        want = np.fft.rfft(xr.astype(np.float64), axis=-1)
    elif family == "c2r":
        m = n // 2 + 1
        y = real.build_c2r_split(desc, F32, device)(t(xr[:, :m]),
                                                    t(xi[:, :m]))
        got = y.double().cpu().numpy()
        spec = xr[:, :m].astype(np.float64) + 1j * xi[:, :m]
        want = np.fft.irfft(spec, n, axis=-1) * n
    else:
        y = r2r.build_r2r(desc, F32, device)(t(xr))
        got = y.double().cpu().numpy()
        want = xr.astype(np.float64) @ ref_matrices.r2r_matrix("redft10", n)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", list(SOLVERS))
def test_dense_solvers_exact_under_reduced_precision(name):
    """Under ``"medium"`` (bf16 products on a CPU with AMX, about 2e-3)
    and ``"high"`` each dense solver stays within 1e-5 of float64 on the
    CPU, and the setting reads back unchanged."""
    for setting in ("medium", "high"):
        torch.set_float32_matmul_precision(setting)
        assert _solver_err(name, "cpu") <= TOL
        assert torch.get_float32_matmul_precision() == setting


def _port_grads(name, rdtype, arrays, w, device="cpu"):
    """Gradients of sum(y * w) through the port's solver `name` built for
    `rdtype` on `device`."""
    family, desc = SOLVERS[name]
    xs = [torch.from_numpy(a.astype(rdtype)).to(device).requires_grad_()
          for a in arrays]
    ws = [torch.from_numpy(a.astype(rdtype)).to(device) for a in w]
    if family == "c2c":
        ys = c2c.build_c2c_split(desc, -1, rdtype, device)(*xs)
    elif family == "r2c":
        ys = real.build_r2c_split(desc, rdtype, device)(*xs)
    elif family == "c2r":
        ys = (real.build_c2r_split(desc, rdtype, device)(*xs),)
    else:
        ys = (r2r.build_r2r(desc, rdtype, device)(*xs),)
    loss = sum((y * v).sum() for y, v in zip(ys, ws))
    return [g.double().cpu().numpy()
            for g in torch.autograd.grad(loss, xs)]


def _grad_inputs(name, rows):
    """Seeded inputs and cotangents of solver `name`."""
    family, desc = SOLVERS[name]
    n = desc["n"]
    m = n // 2 + 1
    rng = np.random.default_rng(n + 1)
    cols = m if family == "c2r" else n
    ins = 1 if family in ("r2c", "r2r") else 2
    outs = 1 if family in ("c2r", "r2r") else 2
    arrays = [rng.standard_normal((rows, cols)).astype(F32)
              for _ in range(ins)]
    ocols = m if family == "r2c" else n
    w = [rng.standard_normal((rows, ocols)).astype(F32)
         for _ in range(outs)]
    return arrays, w


def _grad_err(got, want):
    return max(float(np.max(np.abs(g - f)) / np.max(np.abs(f)))
               for g, f in zip(got, want))


def _jax_grads(name, arrays, w):
    """jax.grad of the same loss through the reference's solver."""
    family, desc = SOLVERS[name]
    if family == "c2c":
        f = ref_c2c.build_c2c_split(desc, -1, F32)
    elif family == "r2c":
        g = ref_real.build_r2c(desc, F32)
        f = (lambda x: (jnp.real(g(x)), jnp.imag(g(x))))
    elif family == "c2r":
        g = ref_real.build_c2r(desc, F32)
        f = (lambda xr, xi: (g(xr + 1j * xi),))
    else:
        g = ref_r2r.build_r2r(desc, F32)
        f = (lambda x: (g(x),))

    def loss(*xs):
        return sum(jnp.sum(y * v) for y, v in zip(f(*xs), w))
    grads = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    return [np.asarray(g, dtype=np.float64) for g in grads]


@pytest.mark.parametrize("setting", ["medium", "high"])
@pytest.mark.parametrize("name", list(SOLVERS))
def test_dense_solver_grads_exact_under_reduced_precision(name, setting):
    """The backward products run after the forward's pin has exited; under
    a reduced setting each dense solver's float32 gradient stays within
    1e-5 of the float64 gradient and of ``jax.grad`` through the
    reference's solver (HIGHEST in its transposed products too), and the
    setting reads back unchanged."""
    arrays, w = _grad_inputs(name, 8)
    want = _port_grads(name, np.float64, arrays, w)
    ref = _jax_grads(name, arrays, w)
    torch.set_float32_matmul_precision(setting)
    got = _port_grads(name, F32, arrays, w)
    assert torch.get_float32_matmul_precision() == setting
    assert [g.shape for g in got] == [g.shape for g in want] \
        == [g.shape for g in ref]
    assert _grad_err(got, want) <= TOL
    assert _grad_err(got, ref) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOLVERS))
def test_dense_solvers_exact_under_high_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    torch.set_float32_matmul_precision("high")
    assert _solver_err(name, "cuda", rows=4096) <= TOL
    assert torch.get_float32_matmul_precision() == "high"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SOLVERS))
def test_dense_solver_grads_exact_under_high_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    arrays, w = _grad_inputs(name, 4096)
    want = _port_grads(name, np.float64, arrays, w)
    torch.set_float32_matmul_precision("high")
    got = _port_grads(name, F32, arrays, w, "cuda")
    assert torch.get_float32_matmul_precision() == "high"
    assert _grad_err(got, want) <= TOL
