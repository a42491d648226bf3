"""Transform kinds, signs and planner flags.

The port's copy of ``fftw3_tpu/kinds.py``: the same names and the same bit
values as FFTW's ``fftw3.h`` (the r2r kind enum at ``fftw3.h:109-110``, the
planner flags at ``fftw3.h:475-489``), so user code and wisdom translate
one-to-one between the two packages.

All transforms are **unnormalized**, exactly like FFTW: a forward transform
followed by a backward transform multiplies the input by N.
"""
from __future__ import annotations

import enum


class Kind(enum.Enum):
    """1-D transform kinds, every one planned by this package: c2c, the
    rdft2 pair r2c/c2r, and the eleven r2r kinds of FFTW's
    ``fftw_r2r_kind`` with its unnormalized definitions ("What FFTW Really
    Computes"), the halfcomplex R2HC/HC2R format included."""

    C2C = "c2c"          # complex -> complex, sign in Problem
    R2C = "r2c"          # real n -> complex n//2+1 (rdft2 format)
    C2R = "c2r"          # complex n//2+1 -> real n (unnormalized inverse)
    # r2r kinds (real -> real, same length):
    R2HC = "r2hc"        # real -> halfcomplex [r0..r_{n/2}, i_{(n+1)/2-1}..i_1]
    HC2R = "hc2r"        # halfcomplex -> real (unnormalized inverse)
    DHT = "dht"          # discrete Hartley transform
    REDFT00 = "redft00"  # DCT-I
    REDFT01 = "redft01"  # DCT-III
    REDFT10 = "redft10"  # DCT-II
    REDFT11 = "redft11"  # DCT-IV
    RODFT00 = "rodft00"  # DST-I
    RODFT01 = "rodft01"  # DST-III
    RODFT10 = "rodft10"  # DST-II
    RODFT11 = "rodft11"  # DST-IV


R2R_KINDS = (
    Kind.R2HC, Kind.HC2R, Kind.DHT,
    Kind.REDFT00, Kind.REDFT01, Kind.REDFT10, Kind.REDFT11,
    Kind.RODFT00, Kind.RODFT01, Kind.RODFT10, Kind.RODFT11,
)


# Transform direction signs (fftw3.h: FFTW_FORWARD/-BACKWARD).
FORWARD = -1
BACKWARD = +1

#: fftw_r2r_kind analog: the type name user code annotates with, and the
#: enum's integer values (FFTW_R2HC = 0 .. FFTW_RODFT11 = 10).  A Kind
#: member, its name and its integer are accepted wherever an r2r kind is
#: expected.
r2r_kind = Kind

R2R_KIND_VALUES = {
    0: Kind.R2HC, 1: Kind.HC2R, 2: Kind.DHT,
    3: Kind.REDFT00, 4: Kind.REDFT01, 5: Kind.REDFT10, 6: Kind.REDFT11,
    7: Kind.RODFT00, 8: Kind.RODFT01, 9: Kind.RODFT10, 10: Kind.RODFT11,
}

# Planner flags, with fftw3.h's bit values.  Memory and alignment bits are
# accepted and ignored: plans take tensors as arguments and never write
# their input.
MEASURE = 0
DESTROY_INPUT = 1 << 0
UNALIGNED = 1 << 1
CONSERVE_MEMORY = 1 << 2
EXHAUSTIVE = 1 << 3
PRESERVE_INPUT = 1 << 4
PATIENT = 1 << 5
ESTIMATE = 1 << 6
WISDOM_ONLY = 1 << 21

#: Patience ladder, least to most patient (the impatience lattice of
#: fftw_mapflags collapsed to four rungs, as in the reference).
PATIENCE_ESTIMATE = 0
PATIENCE_MEASURE = 1
PATIENCE_PATIENT = 2
PATIENCE_EXHAUSTIVE = 3


def patience_of_flags(flags: int) -> int:
    """Map API flag bits onto the planner patience ladder."""
    if flags & ESTIMATE:
        return PATIENCE_ESTIMATE
    if flags & EXHAUSTIVE:
        return PATIENCE_EXHAUSTIVE
    if flags & PATIENT:
        return PATIENCE_PATIENT
    return PATIENCE_MEASURE


def kind_from_name(name) -> Kind:
    """A Kind from a Kind, its name (any case) or its fftw3.h integer."""
    if isinstance(name, Kind):
        return name
    if isinstance(name, int):
        return R2R_KIND_VALUES[name]
    return Kind(name.lower())


def logical_size(kind: Kind, n: int) -> int:
    """Logical size N of one transform, for normalization: a transform
    followed by its unnormalized inverse multiplies by N.  FFTW manual
    "Real even/odd DFTs": REDFT00 pairs with itself at N = 2(n-1), RODFT00
    at N = 2(n+1), REDFT10 with REDFT01 and RODFT10 with RODFT01 at N = 2n,
    REDFT11 and RODFT11 are self-inverse at N = 2n; DHT and R2HC/HC2R have
    N = n."""
    if kind in (Kind.C2C, Kind.R2C, Kind.C2R, Kind.DHT, Kind.R2HC, Kind.HC2R):
        return n
    if kind == Kind.REDFT00:
        return 2 * (n - 1)
    if kind == Kind.RODFT00:
        return 2 * (n + 1)
    return 2 * n
