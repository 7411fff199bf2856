#!/usr/bin/env python3
"""Probes of csrc/estep_many.cu on the card: where a call's time goes, and
which of its two routes is the faster at a shape.

    python3 tools/many_probe.py split [TREE]
    python3 tools/many_probe.py routes

split: for the package under TREE (default: this checkout; a parent
    commit unpacked into a directory that .gitignore lists works too), the
    E-step through estep_general at phase 19 (d)'s path (1, 20, 513, 863)
    real rank 1 and at (8, 20, 513, 863) real rank 1 and complex rank 2
    and (8, 32, 513, 863) real rank 1: CUDA-graph replay ms a call, eager
    CUDA-event ms a call, and device ms a call by kernel
    (chip_smoke.kernel_split: one traced CUDA-graph replay). It reads a
    tree whose chip_smoke.py has no split too.
routes: this checkout's many library and a copy of it whose fused_plan
    takes no shape (so every J takes the chunked route; built beside it
    under chip_checkout/), timed by CUDA-graph replay in turns (fused,
    chunked, chunked, fused) on the same inputs at (B, J, 513, 863) for
    each (B, J, rank, mixing) of ROUTE_CASES: the measurement behind
    kFusedSmem, the bound that sets the routes' crossover. Writes
    chiprun_out/route_probe.json.
Prints the card's name and power limit first. Needs one CUDA card and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((1, 20, 1, True), (8, 20, 1, True), (8, 20, 2, False),
          (8, 32, 1, True))
# (B, J, rank, real mixing) of the routes mode
ROUTE_CASES = ([(8, J, 2, False) for J in (20, 24, 26, 28, 30, 32)]
               + [(8, J, 1, True) for J in (24, 28, 30, 32, 36, 40, 48)]
               + [(8, J, 2, True) for J in (24, 28, 32, 36, 40)]
               + [(8, J, 1, False) for J in (24, 28, 32, 36, 40, 48)]
               + [(1, J, 1, True) for J in (20, 28, 32)])

# the routes mode's copy: fused_plan's first test made to refuse every shape
ROUTE_EDIT = ("estep_many.cu",
              "if (B <= 0 || J <= 0 || F <= 0 || N <= 0 || J > kFusedMaxJ ||",
              "if (true ||")


def _load(path):
    spec = importlib.util.spec_from_file_location(f"probe_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    return _load(ROOT / "chip_smoke.py")


def _call(cs, dev, B, J, R, real):
    from pyfasst_tpu_torch.ops import cuda_estep
    ranks = (R,) * J
    inp = cs._general_inputs(B, J, 513, 863, ranks, real, seed=2, device=dev)
    return lambda: cuda_estep.estep_general(*inp, ranks, real_cov=real)


def split(tree: str, shapes=SHAPES):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from pyfasst_tpu_torch.ops import _build
    cs = _smoke()
    dev = torch.device("cuda", 0)
    _build.build(names=("many",))
    for B, J, R, real in shapes:
        fn = _call(cs, dev, B, J, R, real)
        graph_ms = statistics.median(cs._graph_ms(fn, 5, 10))
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(10):
            fn()
        e1.record()
        torch.cuda.synchronize()
        eager = e0.elapsed_time(e1) / 10
        by_kernel = {k: round(v, 4) for k, v in cs.kernel_split(fn).items()}
        print(f"B={B} J={J} R={R} real={real}: graph replay {graph_ms:.4f} "
              f"ms a call, eager events {eager:.4f}, by kernel (a traced "
              f"graph replay) {json.dumps(by_kernel)}", flush=True)


def routes():
    kc = _load(ROOT / "kernel_compare.py")
    dest = kc.make_copy(ROOT / "chip_checkout" / "routes", [ROUTE_EDIT])
    paths = {side: p["many"] for side, p in kc.build_copies(
        {"fused": ROOT, "chunked": dest}, ("many",)).items()}
    import torch
    from pyfasst_tpu_torch.ops import _build, cuda_estep
    cs = _smoke()
    dev = torch.device("cuda", 0)
    rows = []
    for B, J, R, real in ROUTE_CASES:
        ranks = (R,) * J
        inp = cs._general_inputs(B, J, 513, 863, ranks, real, seed=2,
                                 device=dev)

        def fn():
            return cuda_estep.estep_general(*inp, ranks, real_cov=real)
        ms = {"fused": [], "chunked": []}
        outs = {}
        for side in ("fused", "chunked", "chunked", "fused"):
            _build.load("many", paths[side])
            outs[side] = fn()
            ms[side] += cs._graph_ms(fn, 3, 2)
        same = torch.equal(outs["fused"][0], outs["chunked"][0])
        _build.load("many", paths["fused"])
        plan = cuda_estep.many_plan(B, J, 513, 863, R, real)
        f, c = (statistics.median(ms[k]) for k in ("fused", "chunked"))
        row = dict(B=B, J=J, R=R, real=real, fused_ms=round(f, 4),
                   chunked_ms=round(c, 4), ratio=round(f / c, 3),
                   xi_equal=same, route_now=plan["route"],
                   smem=plan["shared_bytes"])
        rows.append(row)
        print(json.dumps(row), flush=True)
        del inp, outs
        torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "route_probe.json").write_text(
        json.dumps(rows, indent=1))


def main(argv) -> int:
    if not (argv[:1] == ["routes"] and len(argv) == 1
            or argv[:1] == ["split"] and len(argv) <= 2):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    print(_smoke().smi(), flush=True)
    if argv[0] == "split":
        split(argv[1] if len(argv) > 1 else str(ROOT))
    else:
        routes()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
