"""fftw-wisdom-to-conf analog (``fftw/tools/fftw-wisdom-to-conf.in``; the
port of ``fftw3_tpu/tools/wisdom_to_conf.py``).

The reference tool turns a wisdom file into a C configuration routine that
links the wisdom into a program with no file I/O at startup.  The
Python-ecosystem equivalent: emit an importable module that embeds the
wisdom JSON and installs it into the planner on import::

    python -m fftw3_tpu_torch.tools.wisdom_to_conf < wisdom.json > myconf.py
    # or: python -m fftw3_tpu_torch.tools.wisdom_to_conf -w wisdom.json \
    #         -o myconf.py

    import myconf          # installs the embedded wisdom

Compose multiple configurations by importing several generated modules
(like linking several generated C files).
"""
from __future__ import annotations

import argparse
import json
import sys

_TEMPLATE = '''\
"""Embedded fftw3_tpu_torch wisdom (generated by
fftw3_tpu_torch.tools.wisdom_to_conf).

Importing this module installs the wisdom into the global planner —
the fftw-wisdom-to-conf pattern (configuration routine, no file I/O).
"""
import fftw3_tpu_torch

_WISDOM = r"""{payload}"""

if not fftw3_tpu_torch.import_wisdom_from_string(_WISDOM):
    raise ImportError("embedded fftw3_tpu_torch wisdom rejected "
                      "(format/version mismatch?)")
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fftw3_tpu_torch.tools.wisdom_to_conf",
                                 description=__doc__)
    ap.add_argument("-w", "--wisdom-file", default=None,
                    help="wisdom JSON input (default: stdin)")
    ap.add_argument("-o", "--output-file", default=None,
                    help="generated module path (default: stdout)")
    args = ap.parse_args(argv)

    if args.wisdom_file:
        with open(args.wisdom_file) as f:
            payload = f.read()
    else:
        payload = sys.stdin.read()
    try:
        data = json.loads(payload)
        from ..planner import WISDOM_FORMAT
        if data.get("format") != WISDOM_FORMAT:
            raise ValueError("not current-format fftw3-tpu-torch wisdom")
    except (json.JSONDecodeError, ValueError) as exc:
        print(f"error: input is not valid fftw3_tpu_torch wisdom: {exc}",
              file=sys.stderr)
        return 1
    if '"""' in payload:
        print("error: wisdom contains a triple quote", file=sys.stderr)
        return 1

    out = _TEMPLATE.format(payload=payload)
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
