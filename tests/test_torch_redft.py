"""K8, the fused DCT-II / DCT-III kernel (``ops/redft.py``,
``csrc/redft.cu``), and its place in the r2r planner.

On the CPU: the plain version of ``fused_redft10``/``fused_redft01``
against float64 ``x @ r2r_matrix`` (2e-5) and bit for bit against today's
``redft10_half``/``redft01_half`` chains over K4's and K6's twins; its
gradients against those routes' and against the kind matrices'
transposes; ESTIMATE takes it on a CUDA device in float32 inside K4's
window and nowhere else; the descriptors' checks and op counts; the host's
constants against the kernel source's.  Tests marked ``cuda`` hold the
kernel against its plain version and float64 on the card (each skips
itself without a card).  This file imports no JAX.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fftw3_tpu_torch import api, config, models, planner
from fftw3_tpu_torch import plan as plan_mod
from fftw3_tpu_torch.ops import matrices, r2r, redft
from fftw3_tpu_torch.ops import real_stockham as RS
from fftw3_tpu_torch.ops import stockham as S

F32, F64 = np.float32, np.float64
KINDS = ("redft10", "redft01")
CSRC = Path(redft.__file__).resolve().parents[1] / "csrc" / "redft.cu"


@pytest.fixture(autouse=True)
def _modes(monkeypatch):
    """The kernel solvers on for CPU plans (their twins run), the port's
    global planner without wisdom."""
    monkeypatch.setattr(config, "kernel_mode", "on")
    monkeypatch.setattr(planner.the_planner, "wisdom", {})


def _fused(kind, n):
    return {"alg": f"fused_{kind}", "n": n,
            "radices": S.choose_radices(n // 2)}


def _half(kind, n):
    child = "pallas_r2c" if kind == "redft10" else "pallas_c2r"
    return {"alg": f"{kind}_half", "n": n, "child": {
        "alg": child, "n": n, "radices": S.choose_radices(n // 2)}}


def _x(shape, seed=0, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _relerr(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- the plain version -----------------------------------------------------

@pytest.mark.parametrize("shape", [(3,), (2, 5)], ids=["3xn", "2x5xn"])
@pytest.mark.parametrize("n", [256, 512, 1024, 4096])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_equals_float64(kind, n, shape):
    x = _x(shape + (n,), n)
    y = r2r.build_r2r(_fused(kind, n), F32, "cpu")(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert _relerr(y.numpy(), x.astype(F64)
                   @ matrices.r2r_matrix(kind, n)) <= 2e-5


@pytest.mark.parametrize("n", [256, 512, 1024, 4096, 270])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_is_the_half_chains_over_the_twins(kind, n):
    """The plain version is today's reduction over K4's (K6's) twin, bit
    for bit, odd m (n = 270) included."""
    x = torch.from_numpy(_x((3, n), n + 1))
    got = r2r.build_r2r(_fused(kind, n), F32, "cpu")(x)
    want = r2r.build_r2r(_half(kind, n), F32, "cpu")(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_equal_the_existing_routes(kind, n):
    """Autograd through the fused alg (each direction's backward the other
    direction) equals the reduction's gradient and the kind matrix's
    transpose."""
    x = torch.from_numpy(_x((4, n), n + 2))
    w = torch.from_numpy(_x((4, n), n + 3))
    grads = []
    for desc in (_fused(kind, n), _half(kind, n)):
        xs = x.clone().requires_grad_(True)
        (r2r.build_r2r(desc, F32, "cpu")(xs) * w).sum().backward()
        grads.append(xs.grad.numpy())
    want = w.numpy().astype(F64) @ matrices.r2r_matrix(kind, n).T
    assert _relerr(grads[0], want) <= 2e-5
    assert _relerr(grads[0], grads[1]) <= 2e-5


def test_gradient_of_a_batch_shape_and_twice():
    """A (2, 3, n) batch, and the gradient of the gradient (the backward
    is itself differentiable)."""
    n = 512
    fn = r2r.build_r2r(_fused("redft10", n), F32, "cpu")
    x = torch.from_numpy(_x((2, 3, n), 7)).requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x).square().sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), x)
    M = matrices.r2r_matrix("redft10", n)
    want = 2.0 * (x.detach().numpy().astype(F64) @ M) @ M.T
    assert _relerr(g.detach().numpy(), want) <= 2e-5
    assert _relerr(gg.numpy(), 2.0 * np.ones((2, 3, n)) @ M @ M.T) <= 2e-5


# -- the planner -----------------------------------------------------------

@pytest.fixture
def cuda_planner(monkeypatch):
    """A planner that plans for a CUDA device without one: the device's
    wisdom signature stubbed, the kernel mode automatic."""
    monkeypatch.setitem(planner._sig_cache, torch.device("cuda"), "cuda-x")
    monkeypatch.setattr(config, "kernel_mode", "auto")
    return planner.Planner()


@pytest.mark.parametrize("kind", KINDS)
def test_estimate_takes_the_fused_alg_on_cuda(cuda_planner, kind):
    cuda = torch.device("cuda")
    got = cuda_planner.plan_r2r(kind, 512, F32, 0, 64, cuda)
    assert got == _fused(kind, 512)
    assert planner.sprint_desc(got) == f"(fused_{kind}-512)"
    cands = cuda_planner._candidates(kind, 512, F32, 0, 64, cuda)
    assert cands[0] == got and len(cands) == 3
    # rodft10/01: the flip's DCT child
    dst = "rodft" + kind[5:]
    assert cuda_planner.plan_r2r(dst, 512, F32, 0, 64, cuda) == {
        "alg": f"{dst}_flip", "n": 512, "child": got}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,dtype,device", [
    (512, F64, "cuda"), (511, F32, "cuda"), (128, F32, "cuda"),
    (8192, F32, "cuda"), (512, F32, "cpu")])
def test_estimate_keeps_the_reductions_elsewhere(cuda_planner, kind, n,
                                                 dtype, device):
    """float64, odd n, n outside 256-4096 and CPU plans (even with the
    kernels on for CPU plans) are offered no fused alg."""
    if device == "cpu":
        config.kernel_mode = "on"
    cands = cuda_planner._candidates(kind, n, dtype, 0, 64,
                                     torch.device(device))
    assert all(c["alg"] not in redft.KIND_OF for c in cands)
    assert cuda_planner.plan_r2r(kind, n, dtype, 0, 64, device)["alg"] \
        not in redft.KIND_OF


def test_gate_is_k4s_on_cuda():
    config.kernel_mode = "auto"
    for n in range(200, 4200, 2):
        assert redft.applicable(n, F32, "cuda") == \
            RS.r2c_applicable(n, F32, "cuda"), n
        assert not redft.applicable(n, F32, "cpu")
    assert redft.applicable(256, F32, "cuda")
    assert redft.applicable(4096, F32, "cuda")
    assert not redft.applicable(254, F32, "cuda")
    assert not redft.applicable(4098, F32, "cuda")


def test_costs_put_the_fused_alg_first_at_512(cuda_planner):
    """One pass of 8 B a point and 2.5 n log2 n flops: 1.5e-9 s at n =
    512, under today's pick (8.0e-9) and the dense matrix (9.05e-9)."""
    cands = cuda_planner._candidates("redft10", 512, F32, 0, 64,
                                     torch.device("cuda"))
    costs = [cuda_planner._cost("redft10", c) for c in cands]
    assert costs[0] == pytest.approx(1.1 * 8 * 512 / 3.35e12
                                     + 2.5 * 512 * 9 / 6.7e13)
    assert costs[0] == pytest.approx(1.517e-9, rel=1e-3)
    assert costs[0] < min(costs[1:])


@pytest.mark.parametrize("kind,n,desc,ok", [
    ("redft10", 512, _fused("redft10", 512), True),
    ("redft01", 512, _fused("redft01", 512), True),
    ("redft01", 512, _fused("redft10", 512), False),     # another kind
    ("redft10", 512, dict(_fused("redft10", 512), radices=[128]), False),
    ("redft10", 511, dict(_fused("redft10", 512), n=511), False),
    ("redft10", 512, {"alg": "fused_redft10", "n": 512}, False),
    ("rodft10", 512, {"alg": "rodft10_flip", "n": 512,
                      "child": _fused("redft10", 512)}, True),
])
def test_validate_desc(kind, n, desc, ok):
    assert planner.validate_desc(kind, n, desc) is ok


@pytest.mark.parametrize("n", [256, 512, 4096])
@pytest.mark.parametrize("kind", KINDS)
def test_opcount_is_the_reductions(kind, n):
    assert r2r.r2r_opcount(_fused(kind, n)) == \
        r2r.r2r_opcount(_half(kind, n))


def test_stage_span_names_the_kernel():
    assert plan_mod._stage_span(_fused("redft10", 512)) == "fftw.stage.k8"
    assert plan_mod._stage_span(_fused("redft01", 512)) == "fftw.stage.k8"


# -- the host's constants and the kernel's ----------------------------------

def _source():
    return CSRC.read_text()


def test_fixed_plan_is_the_hosts_and_the_kernels():
    """``FIXED_PLAN`` is the host's level plan of ESTIMATE's n = 512
    schedule and the kernel's compiled-in ``Fixed256``: a change to
    ``level_plan`` shows here, and the host stops asking for the
    compiled-in form rather than run stale constants."""
    assert S.choose_radices(256) == [256]
    assert redft.FIXED_PLAN == S.level_plan(256, (256,))
    got = re.search(r"struct Fixed256 \{\s*static constexpr int tl = (\d+);"
                    r"\s*static constexpr int plan\[\] = \{([^}]*)\};",
                    _source())
    assert got
    assert int(got.group(1)) == 1
    assert tuple(int(v) for v in got.group(2).split(",")) == \
        redft.FIXED_PLAN
    assert re.search(r"constexpr int kFixedRows = %d;" % redft.FIXED_ROWS,
                     _source())
    assert redft.fixed_fits(S.level_plan(256, (256,)))
    assert not redft.fixed_fits(S.level_plan(256, (16, 16)))
    assert not redft.fixed_fits(S.level_plan(512, (32, 16)))


def test_every_plan_fits_the_kernel():
    """Every n of the gate, on ESTIMATE's schedule: groups within the
    form's points, shared memory within ``kMaxSmem`` and room for two
    blocks an SM where the plan has one buffer."""
    assert re.search(r"constexpr int kMaxSmem = %d;" % redft.MAX_SMEM,
                     _source())
    assert re.search(r"constexpr int kRunPts = 8, kFixedPts = 16;",
                     _source())
    for n in range(256, 4097, 2):
        if not RS.r2c_applicable(n, F32, "cuda"):
            continue
        m = n // 2
        plan = S.level_plan(m, tuple(S.choose_radices(m)))
        fixed = redft.fixed_fits(plan)
        rpb = redft.FIXED_ROWS if fixed else S.rows_per_block(m)
        assert rpb * m <= (16 if fixed else 8) * 256, n
        smem = redft.redft_smem(plan, m, rpb)
        assert smem <= redft.MAX_SMEM, n
        if plan[1] == 1:
            assert 2 * (smem + 1024 + 520) <= 233472, n


@pytest.mark.parametrize("kind", KINDS)
def test_table_is_k4s_or_k6s_then_the_quarter_twiddle(kind):
    n, rad = 512, (256,)
    sign = -1 if kind == "redft10" else 1
    tab = redft._table(n, rad, sign)
    assert tab.dtype == F32 and tab.size == redft.table_len(n, rad)
    head = RS._real_table(n, rad, sign)
    assert np.array_equal(tab[:head.size], head)
    q = np.exp(sign * 1j * np.pi * np.arange(257) / 1024)
    assert np.array_equal(tab[head.size:], np.concatenate(
        [q.real, q.imag]).astype(F32))


def test_the_launch_refuses_a_cpu_tensor():
    """A tensor off the card never reaches a launch: the wrapper raises
    (the apply runs the plain version only for a CPU tensor)."""
    x = torch.zeros(4, 512)
    table = torch.from_numpy(redft._table(512, (256,), -1))
    with pytest.raises(ValueError, match="CUDA"):
        redft.redft_cuda(x, "redft10", [256], table)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    config.kernel_mode = "auto"
    api._cached_plan.cache_clear()
    yield torch.device("cuda")
    api._cached_plan.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 2048, 4096])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_on_card(card, kind, n):
    """K8 at (300, n) against its plain version and float64 (1e-5), one
    launch a pass."""
    x = _x((300, n), n)
    fn = r2r.build_r2r(_fused(kind, n), F32, card)
    before = redft.launches
    y = fn(torch.from_numpy(x).to(card))
    torch.cuda.synchronize()
    assert redft.launches == before + 1
    got = y.cpu().numpy()
    twin = redft.redft_torch(torch.from_numpy(x), kind,
                             S.choose_radices(n // 2)).numpy()
    assert _relerr(got, twin) <= 1e-5
    assert _relerr(got, x.astype(F64) @ matrices.r2r_matrix(kind, n)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_both_forms_and_every_layout_on_card(card, kind, monkeypatch):
    """At n = 512 the compiled-in form and the run-time form agree; a
    ragged batch, a strided view, an input off 16-byte alignment (the
    threads' own copy in place of the bulk copy), odd m (n = 270) and a
    dense stage (n = 448) all agree with float64."""
    cases = [((37, 512), None), ((5, 2, 512), "strided"),
             ((33, 512), "offset"), ((41, 270), None), ((9, 448), None)]
    for shape, how in cases:
        n = shape[-1]
        x = torch.from_numpy(_x(shape, n)).to(card)
        if how == "strided":
            x = x.transpose(0, 1)
        elif how == "offset":
            x = torch.from_numpy(_x((33 * 512 + 1,), 5)).to(card)[1:] \
                .view(33, 512)
        want = x.double().cpu().numpy() @ matrices.r2r_matrix(kind, n)
        fn = r2r.build_r2r(_fused(kind, n), F32, card)
        fixed = redft.fixed_launches
        got = fn(x)
        assert redft.fixed_launches == fixed + (n == 512)
        assert _relerr(got.cpu().numpy(), want) <= 1e-5, (shape, how)
        if n == 512:
            with monkeypatch.context() as mp:
                mp.setattr(redft, "fixed_fits", lambda plan: False)
                run_time = fn(x)
            assert _relerr(run_time.cpu().numpy(), want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_gradient_on_card(card, kind):
    n = 512
    x = torch.from_numpy(_x((64, n), 3))
    w = torch.from_numpy(_x((64, n), 4))
    xs = x.to(card).requires_grad_(True)
    (r2r.build_r2r(_fused(kind, n), F32, card)(xs) * w.to(card)).sum() \
        .backward()
    want = w.numpy().astype(F64) @ matrices.r2r_matrix(kind, n).T
    assert _relerr(xs.grad.cpu().numpy(), want) <= 1e-5


@pytest.mark.cuda
def test_neumann_solve_launches_k8_six_times(card):
    """A 256^3 Neumann solve (K8's window starts at n = 256) runs six K8
    passes, each a ``fftw.launch.redft`` range inside
    ``fftw.model.neumann_solve``, and agrees with the float64 reference
    (``bench_torch/references/neumann_poisson.py``) within 1e-5."""
    from bench_torch.references import neumann_poisson as ref
    g = torch.Generator(device=card).manual_seed(24)
    f = torch.rand((256, 256, 256), generator=g, device=card) - 0.5
    solve = models.solve_neumann_fn((1 / 256,) * 3)
    u = solve(f)                                   # plans, outside
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = redft.launches
        again = solve(f)
        torch.cuda.synchronize()
    assert redft.launches == before + 6
    assert torch.equal(u, again)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CPU
                     and e.name().startswith("fftw.")),
                    key=lambda e: e.start_ns())
    (head,) = [e for e in events if e.name() == "fftw.model.neumann_solve"]
    launches = [e for e in events if e.name().startswith("fftw.launch.")]
    assert [e.name() for e in launches] == ["fftw.launch.redft"] * 6
    for e in launches:
        assert head.start_ns() <= e.start_ns() <= e.end_ns() <= head.end_ns()
    want = ref.solve(f.double(), (0, 1, 2))
    err = ((u.double() - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-5, err
