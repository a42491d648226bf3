"""fftw3_tpu_torch.ops.c2c against fftw3_tpu.ops.c2c.

Every ported solver runs the reference's own descriptors on the same numpy
input in both packages (JAX on the CPU, torch on the CPU).  Errors are
max-abs error over max-abs of the reference: 2e-5 between the packages in
float32 (different contraction orders, both about 1e-7 from float64), 1e-12
in float64 (which also shows that a complex128 plan stays in f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fftw3_tpu import config as ref_config
from fftw3_tpu import planner as ref_planner
from fftw3_tpu.ops import c2c as ref_c2c

from fftw3_tpu_torch.ops import c2c

TOL = {np.float32: 2e-5, np.float64: 1e-12}

DESCS = {
    "nop": {"alg": "nop", "n": 1},
    "direct": {"alg": "direct", "n": 60},
    "mixed_bfly": {"alg": "mixed", "n": 48, "p": 4,
                   "child": {"alg": "direct", "n": 12}},
    "mixed_einsum": {"alg": "mixed", "n": 384, "p": 16,
                     "child": {"alg": "mixed", "n": 24, "p": 3,
                               "child": {"alg": "direct", "n": 8}}},
    "bluestein": {"alg": "bluestein", "n": 37, "m": 128,
                  "child": {"alg": "mixed", "n": 128, "p": 16,
                            "child": {"alg": "direct", "n": 8}}},
    "rader": {"alg": "rader", "n": 131,
              "child": {"alg": "mixed", "n": 130, "p": 10,
                        "child": {"alg": "direct", "n": 13}}},
    "xla": {"alg": "xla", "n": 100},
}


def _ref_desc(n):
    """The reference planner's own ESTIMATE descriptor, kernels off."""
    old = ref_config.pallas_mode
    ref_config.pallas_mode = "off"
    try:
        return ref_planner.Planner().plan_c2c(n, np.float32, 0)
    finally:
        ref_config.pallas_mode = old


def _compare(desc, sign, rdtype, batch=3):
    n = desc["n"]
    rng = np.random.default_rng(n)
    xr = rng.standard_normal((batch, n)).astype(rdtype)
    xi = rng.standard_normal((batch, n)).astype(rdtype)
    ref = ref_c2c.build_c2c_split(desc, sign, rdtype)
    wr, wi = jax.jit(ref)(jnp.asarray(xr), jnp.asarray(xi))
    want = np.asarray(wr) + 1j * np.asarray(wi)
    mine = c2c.build_c2c_split(desc, sign, rdtype, "cpu")
    yr, yi = mine(torch.from_numpy(xr), torch.from_numpy(xi))
    assert yr.dtype == yi.dtype == (torch.float32 if rdtype == np.float32
                                    else torch.float64)
    got = yr.numpy() + 1j * yi.numpy()
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
    assert err <= TOL[rdtype], (desc, sign, err)
    oracle = np.fft.fft(xr + 1j * xi.astype(np.float64), axis=-1) \
        if sign < 0 else np.fft.ifft(xr + 1j * xi.astype(np.float64),
                                     axis=-1) * n
    assert np.max(np.abs(got - oracle)) / np.max(np.abs(oracle)) \
        <= 10 * TOL[rdtype]


@pytest.mark.parametrize("name", sorted(DESCS))
@pytest.mark.parametrize("sign", [-1, +1])
def test_alg_matches_reference(name, sign):
    _compare(DESCS[name], sign, np.float32)


@pytest.mark.parametrize("n", [1000, 1009, 4096])
def test_reference_planner_descs(n):
    _compare(_ref_desc(n), -1, np.float32, batch=2)


@pytest.mark.parametrize("name", ["direct", "mixed_einsum", "rader"])
def test_complex128_stays_f64(name):
    _compare(DESCS[name], +1, np.float64)


def test_complex_wrapper():
    desc = DESCS["mixed_bfly"]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 48))
         + 1j * rng.standard_normal((2, 48))).astype(np.complex64)
    want = np.asarray(jax.jit(ref_c2c.build_c2c(desc, -1, np.float32))(x))
    got = c2c.build_c2c(desc, -1, np.float32, "cpu")(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    assert np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)) <= 2e-5


PALLAS = [{"alg": "pallas4", "n": 4096, "p": 32, "q": 128},
          {"alg": "pallas", "n": 1024, "radices": [64, 16]},
          {"alg": "pallas", "n": 1024, "radices": [64, 16], "vpu": True},
          {"alg": "pallas", "n": 1024, "radices": [32, 32], "vpu": "all"},
          {"alg": "pallas", "n": 1000, "radices": [50, 20], "vpu": "all"},
          {"alg": "pallas", "n": 256, "radices": [256]}]


@pytest.mark.parametrize("desc", list(DESCS.values()) + PALLAS
                         + [_ref_desc(n) for n in (1000, 1009, 4096)],
                         ids=lambda d: f"{d['alg']}-{d['n']}")
def test_opcount_equals_reference(desc):
    assert c2c.c2c_opcount(desc) == ref_c2c.c2c_opcount(desc)
