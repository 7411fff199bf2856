#!/usr/bin/env python3
"""The readings behind the limits of benchmark/limits/<cell>.json, on the
card, at the cell's own sizes:

    python3 benchmark/calibrate.py --workload stereo_nmf_end1e-3.b8 \
        --seeds 101-112 --control 101-103

For each seed: the cell's pool from that seed, one unit of its traffic
through the timed path (the same call the window makes, after the
warm unit) and the plain reference in float64 on its inputs: the
program's numbers (harness/check.py) and where along the fit its loglik
leaves the reference's (check.spans). For each control seed also the
control in the program's place (the reference's fit in float32 with TF32
matrix products and its state held in bfloat16, its Wiener filter in
bfloat16), which has to come out as not correct; the same with TF32
products alone ("tf32"); and a witness, the reference in plain float32. --set
gem.sigma_end_frac=1e-4 (repeatable) changes a number of the cell's
configuration for a look at another setting. One JSON line a seed; the
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def _read(kept, ref, hold):
    from harness import check
    return {**check.numbers(kept, ref, hold), **check.spans(kept, ref)}


def with_settings(model: dict, settings: list) -> dict:
    """model with each "a.b=value" of settings put in (value as JSON)."""
    model = copy.deepcopy(model)
    for item in settings:
        key, _, value = item.partition("=")
        *path, last = key.split(".")
        node = model
        for k in path:
            node = node[k]
        if last not in node:
            raise KeyError(f"the configuration has no {key!r}")
        node[last] = json.loads(value)
    return model


def readings(cell: str, seed: int, control: bool, device: str = "cuda",
             model: dict = None, traffic_mix: dict = None) -> dict:
    """The program's numbers on one seed; with `control` the control's
    (the fit in float32 with TF32 products and its state in bfloat16, the
    Wiener filter in bfloat16), TF32 products alone, and a float32
    witness's (the reference in plain float32)."""
    import torch

    from harness import check, entries, manifest
    spec = manifest.resolve(ROOT, manifest.load(ROOT), cell)
    entry = entries.ENTRIES[(traffic_mix or spec["traffic"])["entry"]](
        entries.Cell(cell, model or spec["model"],
                     traffic_mix or spec["traffic"], seed, device))
    t0 = time.perf_counter()
    try:
        entry.setup()
        kept = entries.with_steps(
            entry, entry.read_back(entry.keep(entry.unit(1))))
        hold = entries.step_iters(
            entries.gem_config(entry.cell.model))[0]
        entry.release()
        ref = entry.reference(kept)
        out = {"seed": seed, "rerun": check.rerun_gap(kept),
               "program": _read(kept, ref, hold)}
        if control:
            for name, kw in (("control", dict(tf32=True,
                                              low=torch.bfloat16)),
                             ("tf32", dict(tf32=True)), ("float32", {})):
                low = entry.reference(kept, dtype=torch.float32, **kw)
                out[name] = _read(low, ref, hold)
    finally:
        entry.close()
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112")
    ap.add_argument("--control", default="", help="seeds that also run "
                    "the control and the witness, e.g. 101-103")
    ap.add_argument("--set", action="append", default=[],
                    help="e.g. gem.sigma_end_frac=1e-4")
    args = ap.parse_args()
    import torch

    from harness import manifest
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    model = with_settings(manifest.resolve(ROOT, manifest.load(ROOT),
                                           args.workload)["model"], args.set)
    ctrl = set(seeds(args.control)) if args.control else set()
    for s in seeds(args.seeds):
        print(json.dumps({"workload": args.workload, "set": args.set,
                          **readings(args.workload, s, s in ctrl,
                                     model=model)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
