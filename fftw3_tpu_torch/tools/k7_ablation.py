"""K7's ablation and instruction mix on one card (timing only, on no user
path).

    python3 -m fftw3_tpu_torch.tools.k7_ablation [--sass-out FILE]
        [--batch B] [--n N] [--tiles T1,T2,...]
    python3 -m fftw3_tpu_torch.tools.k7_ablation --analyze FILE
        [--model NAME]

Times K7 (``ops/df32.py``, ``csrc/df32_c2c.cu``) at (B, n) on the
schedule ``df32p_radices(n)`` in its four ablation arms
(:data:`df32.ABLATE_ARMS`: ``full``; ``no_twiddle``, the level and stage
complex multiplies skipped; ``skeleton``, identity butterflies with every
load, pass, barrier, permute and store kept; ``copy``, the float64 split on
load and the recombination on store, nothing between), interleaved with
K7's own wrapper and cuFFT Z2Z (``torch.fft.fft`` on complex128): every
arm in order and back, CUDA events, median of 7 reps of 3 calls.  The
``full`` arm is held bit for bit against K7.  With ``--tiles`` it also
times K7 at each tile size (``df32.TILE_POINTS``).  Prints one JSON line
with the card's name and power limit.

With ``--sass-out`` it also writes ``cuobjdump -sass`` of K7's kernels in
the built library to FILE.  :func:`sass_mix` reads such a file (here or
anywhere): per kernel, the instructions by class inside each loop (a loop
is the span from a backward branch's target to the branch), and with a
trip model (:data:`MODELS`, spans of addresses read off one such file) the
instructions each point costs: ``--analyze FILE --model NAME`` prints it,
no card needed.

Runs against any checkout whose ``ops/df32.py`` has ``df32_ablate_cuda``:
``PYTHONPATH=TREE python3 -m fftw3_tpu_torch.tools.k7_ablation``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

#: SASS opcodes by class (the opcode before its first dot)
CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FCHK", "FRND", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD",
             "MUFU"},
    "fp64": {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX"},
    "conversion": {"F2F", "F2I", "I2F", "F2FP", "I2FP", "I2I"},
    "integer": {"IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
                "ISETP", "LEA", "IMNMX", "IABS", "SEL", "PRMT", "IMUL",
                "ISCADD", "BMSK", "SGXT", "POPC", "FLO", "BREV", "IDP",
                "VIADD", "VIMNMX", "PLOP3", "P2R", "R2P", "UIADD3", "ULOP3",
                "USHF", "UIMAD", "ULEA", "UISETP", "USEL", "UPRMT", "UFLO",
                "UPOPC", "UBREV", "USGXT", "UBMSK", "UPLOP3", "UP2UR",
                "UR2UP", "VIADDMNMX"},
    "move": {"MOV", "UMOV", "S2R", "S2UR", "CS2R", "SHFL", "R2UR", "MOV32I"},
    "lds_sts": {"LDS", "STS", "LDSM"},
    "ldg_stg": {"LDG", "STG", "LD", "ST"},
    "local": {"LDL", "STL"},
    "constant": {"LDC", "ULDC"},
    "barrier": {"BAR"},
}
_OP_CLASS = {op: c for c, ops in CLASSES.items() for op in ops}
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)")


def op_class(text: str) -> str:
    """The class of one SASS instruction (``control`` for branches, exits
    and the like, ``other`` for what no class names)."""
    t = re.sub(r"^@!?U?P[T0-9]+\s+", "", text.strip())
    op = t.split()[0].split(".")[0] if t else ""
    if op in _OP_CLASS:
        return _OP_CLASS[op]
    if op in ("BRA", "EXIT", "BSSY", "BSYNC", "WARPSYNC", "NOP", "CALL",
              "RET", "YIELD", "BREAK", "BMOV", "JMP", "JMX", "BRX",
              "ELECT", "VOTE", "VOTEU", "DEPBAR", "MEMBAR", "ERRBAR",
              "CCTL", "FENCE"):
        return "control"
    return "other"


def parse(text: str) -> Dict[str, List[tuple]]:
    """``cuobjdump -sass`` text -> {function: [(address, instruction)]}."""
    out: Dict[str, List[tuple]] = {}
    cur: Optional[List[tuple]] = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def loops(code: List[tuple]) -> List[tuple]:
    """The (start, end) spans of the backward branches, outer first."""
    spans = set()
    for addr, ins in code:
        m = _BRA.search(ins)
        if m and int(m.group(1), 16) <= addr:
            spans.add((int(m.group(1), 16), addr))
    return sorted(spans, key=lambda s: (s[0], -s[1]))


def sass_mix(text: str, match: str = "df32",
             trips: Optional[Sequence[tuple]] = None,
             per_tile: float = 1.0) -> Dict[str, dict]:
    """Per kernel whose name holds `match`: the loops (outer first), each
    with the instructions of its own body by class (not those of loops
    inside it), and the same for the code outside every loop.  With a trip
    model ``trips`` (spans ``(first, last, count)`` of addresses, inclusive:
    how often one thread runs that code per tile; an instruction counts as
    often as the shortest span holding it says, and not at all outside
    every span) the instructions per point by class: the weighted counts
    times ``per_tile`` (threads per tile over points per tile)."""
    res = {}
    for name, code in parse(text).items():
        if match not in name:
            continue
        spans = loops(code)
        bodies = [Counter() for _ in spans]
        outside = Counter()
        per = Counter()
        for addr, ins in code:
            inner = [i for i, (a, b) in enumerate(spans) if a <= addr <= b]
            # the innermost span holding the address: the shortest
            tgt = min(inner, key=lambda i: spans[i][1] - spans[i][0]) \
                if inner else None
            cls = op_class(ins)
            (bodies[tgt] if tgt is not None else outside)[cls] += 1
            if trips:
                held = [t for t in trips if t[0] <= addr <= t[1]]
                if held:
                    per[cls] += min(held, key=lambda t: t[1] - t[0])[2]
        entry = {"instructions": len(code),
                 "outside": dict(outside),
                 "loops": [{"span": [hex(a), hex(b)], "body": dict(c)}
                           for (a, b), c in zip(spans, bodies)]}
        if trips:
            entry["per_point"] = {k: round(v * per_tile, 2)
                                  for k, v in sorted(per.items())}
            entry["per_point_total"] = round(sum(per.values()) * per_tile,
                                             2)
        res[name] = entry
    return res


#: trip models of K7's full arm at (B, 1024) [64, 16]: (first, last, count)
#: address spans of the SASS ``--sass-out`` wrote, read off its branches
#: (the first design's build and this one's, nvcc of CUDA 12.8; an edit
#: of the kernel moves the addresses, and the model's FP32 a point, 413.5
#: here, should stay near ``df32.kernel_instructions`` / n = 408.5).
#: The first design (one row a tile, a pass a level, 256 threads; each
#: thread's runs per tile): the tile loop; the load loop (4); the stage loop (2);
#: the level loop (5 levels); the radix-2, -3 and -5 bodies (never at
#: [64, 16]); the radix-4 body (once a level) and its three level-twiddle
#: blocks (at 3 of the 5 levels); stage 0's twiddle-and-permute loop (4)
#: and its digit_pos loop (3 digits each); the store loop (4) and its
#: digit_pos loop (2 digits each).
MODELS = {
    "first": dict(match="ILi0E", per_tile=256 / 1024, trips=[
        (0x290, 0xfb20, 1), (0x400, 0x5d0, 4), (0x7f0, 0xee90, 2),
        (0xaf0, 0xdd90, 5), (0xe00, 0x1cc0, 0), (0x1ce0, 0x45e0, 0),
        (0x4620, 0xb980, 0), (0xb990, 0xdd30, 5), (0xcde0, 0xd200, 3),
        (0xd220, 0xd6f0, 3), (0xd730, 0xdc00, 3), (0xddc0, 0xed80, 1),
        (0xde10, 0xed70, 4), (0xe390, 0xe770, 12), (0xf150, 0xfad0, 4),
        (0xf4d0, 0xf8b0, 8)]),
    # This design (family 0, four rows a tile): the tile loop; the pass
    # loop (3 passes); the (4, 1) path (pass 2: one round of four tasks,
    # each loading in place, its radix-4 butterfly, no level twiddle, the
    # stage twiddle, the store in place) with its float64 loads, permuted
    # reads, level-twiddle blocks and float64 stores never run; the (4, 4)
    # path (passes 1 and 3, one round each): pass 1 loads the float64
    # input, pass 3 reads stage 0's digit-reversed layout; both run the
    # first level's four butterflies and twiddles and the second level's
    # butterflies, only pass 1 its second level's twiddles and the store in
    # place, only pass 3 the rev load and the float64 store; no stage
    # twiddle in either.
    "current": dict(match="ILi0ELi0E", per_tile=256 / 4096, trips=[
        (0x3910, 0x26ba0, 1), (0x3980, 0x26b50, 3), (0x3d40, 0x13770, 1),
        (0x44a0, 0x48c0, 0), (0x4e40, 0x5270, 0), (0x57d0, 0x5b90, 0),
        (0x60f0, 0x64a0, 0), (0x4120, 0x4270, 0), (0x4ad0, 0x4c10, 0),
        (0x5480, 0x55c0, 0), (0x5da0, 0x5ee0, 0), (0x7350, 0x8160, 0),
        (0xa9a0, 0xb7b0, 0), (0xdee0, 0xec30, 0), (0x111c0, 0x11f10, 0),
        (0x9780, 0x9b10, 0), (0xcdc0, 0xd150, 0), (0x100d0, 0x10430, 0),
        (0x133b0, 0x13710, 0), (0x13780, 0x26b20, 2),
        (0x13a90, 0x143e0, 1), (0x143f0, 0x151e0, 1),
        (0x1bfc0, 0x1cb60, 1), (0x1d6f0, 0x1e290, 1), (0x1ee30, 0x1fa10, 1),
        (0x206e0, 0x21420, 1), (0x21450, 0x214d0, 1),
        (0x214e0, 0x25750, 0), (0x257d0, 0x25f90, 1),
        (0x25fa0, 0x26ad0, 1)]),
}


def cuobjdump_sass(lib: Path) -> str:
    """``cuobjdump -sass`` of the library, the toolkit's own cuobjdump."""
    from ..ops import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


def race(batch: int, n: int, seed: int = 0) -> dict:
    """K7's arms, K7 and cuFFT Z2Z at (batch, n), interleaved: each timed
    in order and back.  Returns {label: [ms, ms]}, the arms' launches and
    each arm's max abs distance from K7's output; raises when the full arm
    differs from K7 in one bit."""
    import numpy as np
    import torch
    from ..ops import df32
    from ..utils import timing
    dev = torch.device("cuda")
    rad = df32.df32p_radices(n)
    rng = np.random.default_rng(seed)
    xr, xi = (torch.from_numpy(rng.standard_normal((batch, n))).to(dev)
              for _ in range(2))
    xc = torch.complex(xr, xi)
    kr, ki = df32.df32_c2c_cuda(xr, xi, rad, -1)
    df32.ablate_launches.clear()
    err = {}
    for a in df32.ABLATE_ARMS:
        fr, fi = df32.df32_ablate_cuda(xr, xi, rad, -1, a)
        if a == "full" and not (torch.equal(kr, fr) and torch.equal(ki, fi)):
            raise RuntimeError("K7's full ablation arm differs from K7")
        err[a] = float(max((fr - kr).abs().max(), (fi - ki).abs().max()))
        del fr, fi
    del kr, ki
    fns = {f"arm {a}": (lambda a_, b_, a=a:
                        df32.df32_ablate_cuda(a_, b_, rad, -1, a))
           for a in df32.ABLATE_ARMS}
    fns["K7 df32_c2c_cuda"] = lambda a_, b_: df32.df32_c2c_cuda(a_, b_, rad,
                                                                -1)
    fns["cuFFT Z2Z torch.fft.fft"] = lambda a_, b_: torch.fft.fft(xc)
    labels = list(fns)
    times = {k: [] for k in labels}
    for k in labels + labels[::-1]:
        times[k].append(timing.time_dispatched(fns[k], (xr, xi), iters=3,
                                               reps=7) * 1e3)
    return {"batch": batch, "n": n, "radices": rad, "times_ms": times,
            "launches": dict(df32.ablate_launches), "max_abs_err": err}


def tile_sweep(batch: int, n: int, tiles: Sequence[int],
               seed: int = 0) -> Dict[int, List[float]]:
    """K7 at (batch, n) with ``df32.TILE_POINTS`` set to each of `tiles`
    (rows per block = TILE_POINTS // n), interleaved in order and back:
    {tile points: [ms, ms]}.  Restores TILE_POINTS."""
    import numpy as np
    import torch
    from ..ops import df32
    from ..utils import timing
    dev = torch.device("cuda")
    rad = df32.df32p_radices(n)
    rng = np.random.default_rng(seed)
    xr, xi = (torch.from_numpy(rng.standard_normal((batch, n))).to(dev)
              for _ in range(2))
    keep = df32.TILE_POINTS
    times: Dict[int, List[float]] = {t: [] for t in tiles}
    try:
        for t in list(tiles) + list(tiles)[::-1]:
            df32.TILE_POINTS = t
            df32.k7_swizzle.cache_clear()
            df32._k7_launch.cache_clear()
            times[t].append(timing.time_dispatched(
                lambda a, b: df32.df32_c2c_cuda(a, b, rad, -1), (xr, xi),
                iters=3, reps=7) * 1e3)
    finally:
        df32.TILE_POINTS = keep
        df32.k7_swizzle.cache_clear()
        df32._k7_launch.cache_clear()
    return times


def static_mix(text: str, match: str = "df32") -> Dict[str, Dict[str, int]]:
    """Per kernel whose name holds `match`: its SASS instructions by class,
    each counted once (no trips)."""
    out = {}
    for name, e in sass_mix(text, match).items():
        c = Counter(e["outside"])
        for lp in e["loops"]:
            c.update(lp["body"])
        out[name] = dict(sorted(c.items()))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--sass-out", default=None)
    ap.add_argument("--tiles", default=None, metavar="T1,T2,...",
                    help="also time K7 at each TILE_POINTS")
    ap.add_argument("--analyze", default=None, metavar="FILE",
                    help="read FILE (--sass-out's) and print the mix of "
                    "K7's full arm per point under --model; no card")
    ap.add_argument("--model", default="current", choices=sorted(MODELS))
    args = ap.parse_args()
    if args.analyze:
        m = MODELS[args.model]
        mix = sass_mix(Path(args.analyze).read_text(), m["match"],
                       m["trips"], m["per_tile"])
        print(json.dumps(mix, indent=1))
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    from ..ops import _build
    lib = _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = race(args.batch, args.n)
    out["card"] = smi
    if args.tiles:
        out["tile_sweep_ms"] = tile_sweep(
            args.batch, args.n, [int(t) for t in args.tiles.split(",")])
    out["registers"] = {k: v for k, v in _build.register_report().items()
                        if "df32" in k}
    if args.sass_out:
        text = cuobjdump_sass(Path(lib._name))
        keep, on = [], False
        for line in text.splitlines():
            if _FUNC.search(line):
                on = "df32" in line
            if on:
                keep.append(line)
        Path(args.sass_out).write_text("\n".join(keep) + "\n")
        out["sass"] = static_mix("\n".join(keep))
    for k, ts in {**out["times_ms"], **{
            f"K7 at TILE_POINTS {t}": v
            for t, v in out.get("tile_sweep_ms", {}).items()}}.items():
        print(f"{k}: {ts[0]:.4f} / {ts[1]:.4f} ms ({smi})")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
