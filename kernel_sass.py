#!/usr/bin/env python3
"""Count the machine instructions of the port's CUDA kernels.

    python3 kernel_sass.py tw_stats_kernel estep_r1_real_kernel

Builds the kernels (ops/_build.py), disassembles its libraries with the CUDA
toolkit's `cuobjdump -sass`, and for every kernel whose name contains one of
the given words prints its instruction count, its opcode histogram, and for
each backward branch (a loop) the instructions between the branch's target
and the branch, with their histogram: what one trip of that loop issues per
warp. The full listing of each kernel goes to chiprun_out/sass/<name>.sass.
It needs nvcc and cuobjdump, but no card; it measures no time. No
profiler runs on the machine with the card, so this static count is what
says how many issue slots a bin or a row costs.
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_INSN = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")


def kernels(listing: str):
    """{mangled name: [(address, text), ...]} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.match(line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(text: str) -> str:
    words = text.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def histogram(insns) -> str:
    count = collections.Counter(opcode(t) for _, t in insns)
    return " ".join(f"{op} {n}" for op, n in count.most_common())


def loops(insns):
    """(target, branch address, body) of each backward branch."""
    for addr, text in insns:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            target = int(m.group(1), 16)
            yield target, addr, [(a, t) for a, t in insns
                                 if target <= a <= addr]


def main(words) -> int:
    sys.path.insert(0, str(ROOT))
    from pyfasst_tpu_torch.ops import _build
    info = _build.build()
    dump = Path(_build.nvcc_path()).with_name("cuobjdump")
    listing = "".join(
        subprocess.run([str(dump), "-sass", path], capture_output=True,
                       text=True, check=True).stdout
        for path in info["paths"].values())
    out_dir = ROOT / "chiprun_out" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, insns in kernels(listing).items():
        if not any(w in name for w in words):
            continue
        (out_dir / f"{name[:120]}.sass").write_text(
            "\n".join(f"{a:06x} {t}" for a, t in insns))
        print(f"{name}: {len(insns)} instructions | {histogram(insns)}")
        for target, addr, body in loops(insns):
            print(f"  loop {target:#x}..{addr:#x}: {len(body)} instructions "
                  f"| {histogram(body)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [""]))
