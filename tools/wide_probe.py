#!/usr/bin/env python3
"""Probe of kernel 1 at J = 9 to 16 sources (the "wide" library,
csrc/estep_j9.cu .. estep_j16.cu) on the card: how a call's time splits
between its phase 1 (thread or lanes = frame: Sigma_x, the leave-one-out
posteriors, xi and the tile's features) and its phase 2 (the frame sums).

    python3 tools/wide_probe.py split [TREE]
    python3 tools/wide_probe.py count [TREE]
    python3 tools/wide_probe.py shares

For the package under TREE (default: this checkout; a parent commit
unpacked into a directory that .gitignore lists works too) it builds two
copies of the wide library under chip_checkout/wide_probe/: the package's
own sources, and a copy whose phase 2 owners are all switched off by a text
edit (PHASE1_EDITS; the shipped source has no switch for it), so that the
copy stops after phase 1. Then, at phase 19 (c)'s path (1, 10, 513, 863)
real rank 1 and at (8, J, 513, 863) for J = 10, 12 and 16 at real rank 1,
complex rank 1 and complex rank 2 (SHAPES), it times both copies by CUDA-
graph replay in turns (whole, phase 1, phase 1, whole) on the same inputs,
and prints each instantiation's resident warps per SM, registers and local
(spill) bytes, and its machine instructions (kernel_sass.py's count, from
cuobjdump -sass of each copy): the kernel's, the tile loop's (its longest
backward branch) and each inner loop's (phase 2's loops over quads of four
frames; in the phase-1 copy the tile loop is phase 1's per tile). Writes
chiprun_out/wide_probe.json. count: the same without timing (each
shape's call runs once, unchecked): the instruction counts and the
runtime's figures alone. Prints the card's name and power limit first.
Needs one CUDA card, nvcc and cuobjdump; imports nothing of JAX.

shares: phase 2's split of the frame sums at every instantiation of J = 5
to 16 as the compiler sees it (csrc/estep_general.cuh compiled by g++
against tests/cuda_shim/, no card): the kernel (FRAMES or WIDE), its
lanes a frame in phase 1 and frames a tile, and per role (Tss, T7, the
sources' Txs) its owners, lanes a group, slots (owners a thread) and busy
share: owners x quads of a tile over threads x the quads of the busiest
thread, and the same for FRAMES' split ("frames_*"). Also its shared
bytes a block and the blocks an SM it asks for.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (B, J, rank, real mixing) at F = 513, N = 863
SHAPES = ((1, 10, 1, True),) + tuple(
    (8, J, R, real) for J in (10, 12, 16)
    for R, real in ((1, True), (1, False), (2, False)))
# switch phase 2's owners off: the three roles of estep_frames_kernel and of
# estep_wide_kernel; each edit is made wherever its text occurs
PHASE1_EDITS = (
    ("if (o < SP::O_TSS && nq > 0) {", "if (false) {"),
    ("if (o < SP::O_T7 && nq > 0) {", "if (false) {"),
    ("if (o < SP::O_SRC && nq > 0)", "if (false)"),
    ("if (o < WP::O_TSS && nq > 0) {", "if (false) {"),
    ("if (o < WP::O_T7 && nq > 0) {", "if (false) {"),
    ("if (o < WP::O_SRC && nq > 0)", "if (false)"),
)
# and the copy's own name for pick's record of the instantiations whose
# shared memory it has allowed: a static of a template function is one
# object in a process (g++'s unique symbols), so both copies, loaded side
# by side, would otherwise share it
RENAME = (("static bool allowed[", "static bool allowed_phase1["),
          ("bool& done = allowed[", "bool& done = allowed_phase1["))
HEADER = "estep_general.cuh"


def _load(path):
    spec = importlib.util.spec_from_file_location(f"probe_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    return _load(ROOT / "chip_smoke.py")


def _sass():
    return _load(ROOT / "kernel_sass.py")


def copies(tree: Path,
           base: Path = ROOT / "chip_checkout" / "wide_probe") -> dict:
    """{"whole": dir, "phase1": dir}: the package under `tree` copied twice
    under `base` (kernel_compare.make_copy), the second
    with those of PHASE1_EDITS and RENAME made whose text the tree's header
    holds (a tree from before the WIDE kernel has FRAMES' only)."""
    kc = _load(ROOT / "kernel_compare.py")
    text = (Path(tree) / "pyfasst_tpu_torch" / "csrc" / HEADER).read_text()
    if not any(old in text for old, _ in PHASE1_EDITS):
        raise SystemExit("no phase 2 owner test found to switch off")
    return {"whole": kc.make_copy(base / "whole", (), tree),
            "phase1": kc.make_copy(base / "phase1", [
                (HEADER, old, new) for old, new in PHASE1_EDITS + RENAME
                if old in text], tree)}


def build(dirs: dict) -> dict:
    """Builds each copy's wide library, the nvcc runs of both started
    together (kernel_compare.build_copies); {side: path of its library}."""
    kc = _load(ROOT / "kernel_compare.py")
    return {side: p["wide"]
            for side, p in kc.build_copies(dirs, ("wide",)).items()}


def sass_counts(paths: dict) -> dict:
    """{side: {mangled kernel name: {"insns", "loop", "inner",
    "loop_histogram", "histogram"}}} of the kernels of each library: the
    kernel's instructions, its longest loop's (the tile loop) and those of
    each loop inside it, and the opcode histograms of the tile loop and
    of the kernel."""
    ks = _sass()
    from pyfasst_tpu_torch.ops import _build
    dump = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for side, path in paths.items():
        listing = subprocess.run([str(dump), "-sass", path],
                                 capture_output=True, text=True,
                                 check=True).stdout
        out[side] = {}
        for name, insns in ks.kernels(listing).items():
            spans = sorted(((a, b, len(body)) for a, b, body
                            in ks.loops(insns)), key=lambda s: s[0] - s[1])
            outer = spans[0] if spans else None
            inner = [n for a, b, n in spans[1:]
                     if outer and outer[0] <= a and b <= outer[1]]
            body = [(a, t) for a, t in insns
                    if outer and outer[0] <= a <= outer[1]]
            out[side][name] = {"insns": len(insns),
                               "loop": outer[2] if outer else 0,
                               "inner": inner,
                               "loop_histogram": ks.histogram(body),
                               "histogram": ks.histogram(insns)}
    return out


def mangled(J: int, R: int, real: bool) -> str:
    """The part of a general E-step kernel's mangled name that names its
    instantiation at (J, R, real mixing, no ns_inj)."""
    return f"ILi{J}ELi{R}ELb{int(real)}ELb0E"


def split(tree: str, timed: bool = True):
    tree_dir = Path(tree).resolve()
    dirs = copies(tree_dir)
    paths = build(dirs)
    sys.path.insert(0, str(ROOT))
    import torch
    from pyfasst_tpu_torch.ops import _build, cuda_estep
    cs = _smoke()
    counts = sass_counts(paths)
    dev = torch.device("cuda", 0)
    rows = []
    for B, J, R, real in SHAPES:
        ranks = (R,) * J
        inp = cs._general_inputs(B, J, 513, 863, ranks, real, seed=2,
                                 device=dev)

        def fn():
            return cuda_estep.estep_general(*inp, ranks, real_cov=real)
        ms = {"whole": [], "phase1": []}
        info = {}
        for side in ("whole", "phase1", "phase1", "whole"):
            _build.load("wide", paths[side])
            fn()
            if timed:
                ms[side] += cs._graph_ms(fn, 5, 10)
            info[side] = _build.kernel_info(f"estep_j{J}", R, int(real), 0)
        whole, p1 = (statistics.median(ms[s]) if timed else float("nan")
                     for s in ("whole", "phase1"))
        sass = {side: {n: c for n, c in counts[side].items()
                       if mangled(J, R, real) in n}
                for side in counts}
        row = dict(B=B, J=J, R=R, real=real, whole_ms=round(whole, 4),
                   phase1_ms=round(p1, 4), phase2_ms=round(whole - p1, 4),
                   phase1_share=round(p1 / whole, 3), info=info,
                   sass={s: {n: {k: v for k, v in c.items()
                                 if k != "histogram"}
                             for n, c in d.items()}
                         for s, d in sass.items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
        del inp
        torch.cuda.empty_cache()
    _build.load("wide", paths["whole"])
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "wide_probe.json").write_text(json.dumps(
        {"card": cs.smi(), "tree": str(tree_dir), "rows": rows,
         "histograms": {s: {n: c["histogram"] for n, c in d.items()}
                        for s, d in counts.items()}}, indent=1))


SHARES_CPP = r"""
#include <cstdio>
#include "estep_general.cuh"
using namespace pyfasst_general;
template <class P>
void role(const char* name, int owners, int L, int quads) {
  const int slots = ceil_div(owners, L), groups = kGenThreads / L;
  const int per = ceil_div(quads, groups);
  std::printf(", \"%s\": [%d, %d, %d, %.3f]", name, owners, L, slots,
              (double)owners * quads / ((double)kGenThreads * slots * per));
}
template <int J, int R, bool REAL, bool NS>
void show() {
  using W = Wide<J, R, REAL, NS>;
  using P = Split<J, R, REAL, NS>;
  const bool wide = W::G > 0;
  const int frames = wide ? W::TF : kFrames;
  std::printf("{\"J\": %d, \"R\": %d, \"real\": %d, \"ns\": %d, "
              "\"kernel\": \"%s\", \"lanes_a_frame\": %d, "
              "\"frames\": %d, \"bytes\": %zu, \"blocks\": %d",
              J, R, (int)REAL, (int)NS, wide ? "WIDE" : "FRAMES",
              wide ? W::G : 1, frames, wide ? W::BYTES : P::BYTES,
              wide ? W::MIN_BLOCKS : P::MIN_BLOCKS);
  if (wide) {
    role<W>("tss", W::O_TSS, W::L_TSS, frames / 4);
    role<W>("t7", W::O_T7, W::L_T7, frames / 4);
    role<W>("src", W::O_SRC, W::L_SRC, frames / 4);
  }
  // FRAMES' split of the same instantiation (what it takes where WIDE
  // does not)
  role<P>("frames_tss", P::O_TSS, P::L_TSS, kFrames / 4);
  role<P>("frames_t7", P::O_T7, P::L_T7, kFrames / 4);
  role<P>("frames_src", P::O_SRC, P::L_SRC, kFrames / 4);
  std::printf("}\n");
}
template <int J>
void all() {
  show<J, 1, true, false>();
  show<J, 1, false, false>();
  show<J, 2, true, false>();
  show<J, 2, false, false>();
  show<J, 1, false, true>();
  show<J, 2, false, true>();
}
int main() {
  all<5>(); all<6>(); all<7>(); all<8>(); all<9>(); all<10>(); all<11>();
  all<12>(); all<13>(); all<14>(); all<15>(); all<16>();
}
"""


def shares():
    """Prints one JSON line per instantiation (SHARES_CPP) from a g++ build
    of the header against the shim (the shim test's translation)."""
    import tempfile
    sys.path.insert(0, str(ROOT))
    from tests.test_torch_csrc_shim import translate
    csrc = ROOT / "pyfasst_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in ("recip.cuh", HEADER):
            (tmp / name).write_text(translate((csrc / name).read_text()))
        (tmp / "shares.cpp").write_text(SHARES_CPP)
        subprocess.run(["g++", "-std=c++20", "-O0", "-pthread", "-I",
                        str(tmp), "-I", str(ROOT / "tests" / "cuda_shim"),
                        "-o", str(tmp / "shares"), str(tmp / "shares.cpp")],
                       check=True)
        print(subprocess.run([str(tmp / "shares")], check=True,
                             capture_output=True, text=True).stdout, end="")


def main(argv) -> int:
    if argv == ["shares"]:
        shares()
        return 0
    if not (argv[:1] in (["split"], ["count"]) and len(argv) <= 2):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    print(_smoke().smi(), flush=True)
    split(argv[1] if len(argv) > 1 else str(ROOT), timed=argv[0] == "split")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
