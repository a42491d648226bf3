"""FFTW bench problem strings, as the configurations name their transforms.

The grammar of FFTW's bench program (``tests/README`` in the FFTW sources)::

    [i|o][/][d][r|c|k][f|b|+|-][t] SIZES [v BATCH | * BATCH]
    SIZES := INT[KIND] ('x' INT[KIND])*
    INT   := digits, then 'k' (x 1024) or 'm' (x 1024^2) optionally
    KIND  := f | b | h | e00 | e01 | e10 | e11 | o00 | o01 | o10 | o11

A copy of the parser the port's harness has, cut to what a configuration
uses (no explicit strides; the layout letters ``i o / d t`` are read and
left to the traffic mix's entry point), so that a change to the program
cannot move the yardstick.  A batch set by a traffic mix replaces the
string's own.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace
from typing import Tuple

FORWARD, BACKWARD = -1, 1


@dataclass(frozen=True)
class Problem:
    kind: str                   # 'c2c' | 'r2c' | 'c2r' | 'r2r'
    sizes: Tuple[int, ...]      # transform extents, row-major
    sign: int = FORWARD
    batch: Tuple[int, ...] = ()  # leading vector extents
    r2r: Tuple[str, ...] = ()   # one kind code per axis, r2r only
    text: str = ""

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.batch + self.sizes

    @property
    def axes(self) -> Tuple[int, ...]:
        nb = len(self.batch)
        return tuple(range(nb, nb + len(self.sizes)))

    @property
    def nbatch(self) -> int:
        return math.prod(self.batch)

    @property
    def points(self) -> int:
        return math.prod(self.shape)

    @property
    def logical_n(self) -> int:
        """Points of one logical transform, FFTW's N for normalised flops
        (``libbench2/mflops.c``): a DCT-I of n points counts 2(n - 1)."""
        if self.kind != "r2r":
            return math.prod(self.sizes)
        return math.prod(_logical_size(k, n)
                         for k, n in zip(self.r2r, self.sizes))

    def with_batch(self, batch: int) -> "Problem":
        """The same transform over `batch` vectors; 1 means no batch
        axis, as ``plan_dft`` takes a single transform."""
        return replace(self, batch=() if batch == 1 else (int(batch),))


def _logical_size(code: str, n: int) -> int:
    if code in ("f", "b", "h"):
        return n
    if code == "e00":
        return 2 * (n - 1)
    if code == "o00":
        return 2 * (n + 1)
    return 2 * n


def _parse_int(s: str, pos: int) -> Tuple[int, int]:
    m = re.match(r"\d+", s[pos:])
    if not m:
        raise ValueError(f"expected a size at {s[pos:]!r} in {s!r}")
    n, pos = int(m.group(0)), pos + m.end()
    if pos < len(s) and s[pos] in "kK":
        n, pos = n * 1024, pos + 1
    elif pos < len(s) and s[pos] in "mM":
        n, pos = n * 1024 * 1024, pos + 1
    return n, pos


def _parse_sizes(s: str, pos: int, r2r: bool):
    sizes, codes = [], []
    while True:
        n, pos = _parse_int(s, pos)
        sizes.append(n)
        if r2r:
            m = re.match(r"[fbh]|[eo](00|01|10|11)", s[pos:])
            codes.append(m.group(0) if m else "f")
            pos += m.end() if m else 0
        if pos < len(s) and s[pos] in "xX":
            pos += 1
            continue
        return tuple(sizes), tuple(codes), pos


def parse(text: str) -> Problem:
    """The problem a bench string names, e.g. ``cf1024``,
    ``cf512x512x512``, ``rf2048x2048v8``, ``k512e10v65536``."""
    pos, sign, kind = 0, FORWARD, "c"
    while pos < len(text) and text[pos] in "io/dcrkfb+-t":
        c = text[pos]
        if c in "crk":
            kind = c
        elif c in "f-":
            sign = FORWARD
        elif c in "b+":
            sign = BACKWARD
        pos += 1
    sizes, codes, pos = _parse_sizes(text, pos, kind == "k")
    batch: Tuple[int, ...] = ()
    if pos < len(text) and text[pos] in "vV*":
        batch, _, pos = _parse_sizes(text, pos + 1, False)
    if pos != len(text):
        raise ValueError(f"trailing {text[pos:]!r} in problem {text!r}")
    pkind = {"c": "c2c", "k": "r2r"}.get(
        kind, "r2c" if sign == FORWARD else "c2r")
    return Problem(pkind, sizes, sign, batch, codes, text)
