"""Instruction counts of a hand kernel's main loop, from its compiled SASS.

Builds ``csrc/<source>.cu`` (as the kernels build on first use), dumps the
library's SASS with ``cuobjdump -sass`` and, for each kernel whose mangled
name contains one of ``--match``, counts the opcodes between the target
and the source of its longest backward branch (the main K loop).  One
JSON line per kernel: the loop's instruction count, its integer-pipe
count (IMAD, PRMT, LOP3, SHF, IADD3, ...), its MMAs, and the opcode
histogram.  Used for the decode cost of the kernels on
``csrc/ternary_mma.cuh``: their ``packed_kernel<MODE, NT, WN, RT, Enc>``
instantiations are matched by the mangled ``ILi<MODE>ELi<NT>ELi<WN>ELi<RT>E``.
By default the 4 x 16-column layout at one 8-row tile: ``packed_matmul``'s
bf16 (mode 1) and s8 (mode 3, ``w2a8``) loops, ``tl2_matmul``'s bf16 (mode
1) and s8 (mode 4) loops; ``grouped_matmul``'s bf16 and s8 loops in that
layout and in the 2 x 32-column one that phi3.5-moe's expert stacks run.

Usage (on a machine with the CUDA toolkit):
  python -m repro_torch.launch.sass_count \\
      [--source packed_matmul|tl2_matmul|grouped_matmul] \\
      [--match ILi1ELi1ELi4ELi1E ILi3ELi1ELi4ELi1E]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess

INTEGER = {"IMAD", "IADD3", "LOP3", "SHF", "PRMT", "IMUL", "LEA", "ISETP",
           "SEL", "IMNMX", "VIADD", "VIMNMX", "BFE", "SGXT"}
#: per source, the instantiations counted by default (see above)
DEFAULT_MATCH = {"packed_matmul": ["ILi1ELi1ELi4ELi1E", "ILi3ELi1ELi4ELi1E"],
                 "tl2_matmul": ["ILi1ELi1ELi4ELi1E", "ILi4ELi1ELi4ELi1E"],
                 "grouped_matmul": ["ILi1ELi1ELi4ELi1E", "ILi3ELi1ELi4ELi1E",
                                    "ILi1ELi1ELi2ELi2E", "ILi3ELi1ELi2ELi2E"]}
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def loop_counts(sass: str) -> dict:
    """Opcode counts of the longest backward-branch loop of one function's
    SASS text."""
    lines = [(int(a, 16), ins.split()) for a, ins in _LINE.findall(sass)]
    span = None
    for addr, words in lines:
        text = " ".join(words)
        target = re.search(r"BRA\s+0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            if span is None or addr - lo > span[1] - span[0]:
                span = (lo, addr)
    ops = collections.Counter()
    for addr, words in lines:
        if span and span[0] <= addr <= span[1]:
            op = words[1] if words[0].startswith("@") else words[0]
            ops[op.split(".")[0]] += 1
    return {"loop_instructions": sum(ops.values()),
            "loop_integer": sum(n for op, n in ops.items() if op in INTEGER),
            "loop_mma": ops["HMMA"] + ops["IMMA"],
            "loop_ops": dict(ops.most_common())}


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="packed_matmul")
    ap.add_argument("--match", nargs="+", default=None)
    args = ap.parse_args(argv)
    if args.match is None:
        args.match = DEFAULT_MATCH[args.source]
    from repro_torch.kernels import _build

    _build.build_all([args.source])
    so = _build._target(args.source)[1]
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        for m in args.match:
            if m in name:
                out.append({"source": args.source, "match": m,
                            **loop_counts(func)})
                print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
