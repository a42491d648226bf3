"""Bench problem-string parser — the port of ``fftw3_tpu/harness/problem.py``.

Implements the grammar of the reference bench harness
(``fftw/libbench2/problem.c:119-318`` and ``fftw/tests/README:8-40``)::

    [i|o][/][d][r|c|k][f|b|+|-][t] SIZES [v BATCH | * BATCH]

    SIZES := INT[KIND][':' STRIDE[':' STRIDE]] ('x' SIZES)*
    INT   := [+-]?[0-9]+ ('k'|'K' => *1024) ('m'|'M' => *1024^2)
    KIND  := f | b | h | e{00,01,10,11} | o{00,01,10,11}   (r2r only)

Flag letters: ``i``/``o`` in-place/out-of-place (accepted; a functional
engine has no aliasing, so this only annotates the problem), ``d`` may
destroy input (no-op), ``/`` split re/im arrays (the speed test then
times the plan's ``apply_split``, the kernels' own form), ``r`` real (r2c
forward / c2r backward), ``c`` complex, ``k`` r2r,
``f``/``-`` forward, ``b``/``+`` backward, ``t`` transposed I/O layout.
Explicit strides equal to the contiguous row-major default are accepted
(they are expressible on logical arrays); any other stride describes a
*physical* CPU layout and raises :class:`UnsupportedProblem`.

Examples: ``c1024``, ``ib256``, ``32x64``, ``ocf1024``, ``r2048x2048``,
``k512e10v4096`` (batched DCT-II; kind codes follow the size),
``c1024v64``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

from .. import kinds as K


class UnsupportedProblem(ValueError):
    """Problem is parseable but not expressible on logical arrays."""


_R2R_CODE = {
    "f": K.Kind.R2HC, "b": K.Kind.HC2R, "h": K.Kind.DHT,
    "e00": K.Kind.REDFT00, "e01": K.Kind.REDFT01,
    "e10": K.Kind.REDFT10, "e11": K.Kind.REDFT11,
    "o00": K.Kind.RODFT00, "o01": K.Kind.RODFT01,
    "o10": K.Kind.RODFT10, "o11": K.Kind.RODFT11,
}


@dataclass
class BenchProblem:
    """Parsed logical problem (bench_problem analog)."""
    kind: str                       # 'c2c' | 'r2c' | 'c2r' | 'r2r'
    sizes: Tuple[int, ...]          # transform extents, row-major
    sign: int = K.FORWARD
    r2r_kinds: Tuple[K.Kind, ...] = ()
    batch: Tuple[int, ...] = ()     # vector/batch extents (leading dims)
    in_place: bool = False
    split: bool = False
    destroy_input: bool = False
    transposed: bool = False
    pstring: str = ""

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.batch + self.sizes

    @property
    def axes(self) -> Tuple[int, ...]:
        nb = len(self.batch)
        return tuple(range(nb, nb + len(self.sizes)))

    @property
    def logical_n(self) -> int:
        """Product of logical transform sizes (mflops normalization)."""
        total = 1
        if self.kind == "r2r":
            for n, k in zip(self.sizes, self.r2r_kinds):
                total *= K.logical_size(k, n)
        else:
            for n in self.sizes:
                total *= n
        return total

    @property
    def nbatch(self) -> int:
        total = 1
        for b in self.batch:
            total *= b
        return total


def _parse_int(s: str, pos: int) -> Tuple[int, int]:
    m = re.match(r"[+-]?\d+", s[pos:])
    if not m:
        raise ValueError(f"expected integer at {s[pos:]!r} in {s!r}")
    n = int(m.group(0))
    pos += m.end()
    if pos < len(s) and s[pos] in "kK":
        n *= 1024
        pos += 1
    if pos < len(s) and s[pos] in "mM":
        n *= 1024 * 1024
        pos += 1
    return n, pos


def _parse_tensor(s: str, pos: int, want_kinds: bool):
    """Parse INT[KIND][:is[:os]] ('x' ...)* -> (sizes, kinds, pos)."""
    sizes, kinds, strides = [], [], []
    while True:
        n, pos = _parse_int(s, pos)
        sizes.append(n)
        if pos < len(s) and s[pos] == ":":
            ist, pos = _parse_int(s, pos + 1)
            ost = ist
            if pos < len(s) and s[pos] == ":":
                ost, pos = _parse_int(s, pos + 1)
            strides.append((len(sizes) - 1, ist, ost))
        kind = K.Kind.R2HC
        if pos < len(s):
            c = s[pos].lower()
            if c in "fbh":
                kind = _R2R_CODE[c]
                pos += 1
            elif c in "eo":
                m = re.match(r"(00|01|10|11)", s[pos + 1:])
                if m:
                    kind = _R2R_CODE[c + m.group(0)]
                    pos += 1 + m.end()
        kinds.append(kind)
        if pos < len(s) and s[pos] in "xX":
            pos += 1
            continue
        break
    if strides:
        # contiguous row-major defaults ARE expressible on logical arrays;
        # anything else describes a physical CPU layout we reject
        default = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            default[i] = default[i + 1] * sizes[i + 1]
        for ax, ist, ost in strides:
            if ist != default[ax] or ost != default[ax]:
                raise UnsupportedProblem(
                    "non-contiguous explicit strides describe physical CPU "
                    "layouts; express layout with array shape/axes instead")
    return tuple(sizes), tuple(kinds), pos


def parse_problem(s: str) -> BenchProblem:
    """Parse a bench problem string (problem_parse analog)."""
    orig = s
    pos = 0
    in_place = False
    split = False
    destroy = False
    transposed = False
    sign = K.FORWARD
    kind = "complex"
    while pos < len(s):
        c = s[pos].lower()
        if c == "i":
            in_place = True
        elif c == "o":
            in_place = False
        elif c == "d":
            destroy = True
        elif c == "/":
            split = True
        elif c in ("f", "-"):
            sign = K.FORWARD
        elif c in ("+",):
            sign = K.BACKWARD
        elif c == "b":
            sign = K.BACKWARD
        elif c == "r":
            kind = "real"
        elif c == "c":
            kind = "complex"
        elif c == "k":
            kind = "r2r"
        elif c == "t":
            transposed = True
        elif c in ("[", "]"):
            pass                        # MPI scrambled flags: annotation only
        else:
            break
        pos += 1
    sizes, r2r_kinds, pos = _parse_tensor(s, pos, kind == "r2r")
    batch: Tuple[int, ...] = ()
    if pos < len(s) and s[pos] in "vV*":
        batch, _, pos = _parse_tensor(s, pos + 1, False)
    if pos != len(s):
        raise ValueError(f"trailing junk {s[pos:]!r} in problem {orig!r}")

    if kind == "complex":
        pkind = "c2c"
        r2r_kinds = ()
    elif kind == "real":
        pkind = "r2c" if sign == K.FORWARD else "c2r"
        r2r_kinds = ()
    else:
        pkind = "r2r"

    return BenchProblem(kind=pkind, sizes=sizes, sign=sign,
                        r2r_kinds=r2r_kinds, batch=batch, in_place=in_place,
                        split=split, destroy_input=destroy,
                        transposed=transposed, pstring=orig)


def make_plan(prob: BenchProblem, flags: int = K.ESTIMATE,
              dtype: Optional[str] = None, device=None):
    """Build a plan for a parsed bench problem on `device` (default
    ``config.device``)."""
    from .. import api

    if prob.kind == "c2c":
        return api.plan_dft(prob.shape, prob.axes, prob.sign, flags,
                            dtype or "complex64", device)
    if prob.kind == "r2c":
        return api.plan_dft_r2c(prob.shape, prob.axes, flags,
                                dtype or "float32", device)
    if prob.kind == "c2r":
        return api.plan_dft_c2r(prob.shape, prob.axes, flags,
                                dtype or "float32", device)
    return api.plan_r2r(prob.shape, list(prob.r2r_kinds), prob.axes, flags,
                        dtype or "float32", device)
