#!/usr/bin/env python3
"""Run one cell of the benchmark of pyfasst_tpu_torch once, on one card.

    python3 benchmark/run.py --workload stereo_nmf_end1e-3.b8 --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. Set-up makes the cell's clips and initial
parameters from --seed and warms the cell's shapes with one unit of its
traffic (a first run in a checkout also builds the port's kernels with
nvcc, into pyfasst_tpu_torch/_build/). The window then runs units back to
back and closes at the first unit that ends past --seconds. After it, on
one unit drawn from the seed, the plain reference
(benchmark/harness/reference.py) follows the whole fit from the same
inputs and one iteration from each of the program's own states before
the first spatial update, the middle and the last iteration (the unit's
GEM run again to record them), and makes the images from the program's
final state (harness/check.py). The numbers that decide `correct` are
printed beside their limits (benchmark/limits/<cell>.json), last on
standard error and last in the result. The last line of standard output
is the result: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from spans around the harness's
calls into the port and from one torch.profiler window of GEM
iterations 60-80 after the window.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is visible, and 1 when the process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "pyfasst_tpu")


def process_start() -> float:
    """The process's start on the wall clock, from /proc (the module's
    import time where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT


class Readings:
    """What a metric reader (benchmark/metrics/<name>.py) reads: the
    window's counts and clocks, the spans of the traced run, the profiled
    GEM chunk, and the cell's shape-derived figures (harness/counts)."""

    def __init__(self, cell, model, traffic, shapes):
        self.cell, self.model, self.traffic = cell, model, traffic
        self.shapes = shapes                  # (B, J, F, N, K)
        self.niter = model["gem"]["niter"]
        self.spans = {k: [] for k in ("gem_s", "enqueue_s", "init_s",
                                      "separate_s", "events")}
        self.trace = None
        self._figures = None

    def figures(self) -> dict:
        if self._figures is None:
            from harness import counts
            self._figures = counts.cell_figures(*self.shapes)
        return self._figures


def run(cell: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = ROOT, model: dict = None,
        traffic_mix: dict = None, start: float = None) -> dict:
    """One run of `cell`; returns the result's dict. `model` and
    `traffic_mix` replace the cell's files (the tests' small sizes)."""
    import numpy as np
    import torch

    from harness import check, entries, manifest, profile
    start = time.time() if start is None else start
    spec = manifest.resolve(root, manifest.load(root), cell)
    model = model or spec["model"]
    traffic_mix = traffic_mix or spec["traffic"]
    entry = entries.ENTRIES[traffic_mix["entry"]](
        entries.Cell(cell, model, traffic_mix, seed, device))
    shapes = (traffic_mix["batch"], model["sources"], entry.F, entry.N,
              model["nmf_rank"])
    r = Readings(cell, model, traffic_mix, shapes)
    cuda = torch.device(device).type == "cuda"
    try:
        entry.setup()
        r.setup_s = time.time() - start
        if cuda:
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        pick = np.random.default_rng([int(seed) % 2 ** 64, 5])
        spans = r.spans if trace else None
        health, kept, failed, n = [], None, 0, 0
        t0 = time.perf_counter()
        ends = [t0]
        while True:
            n += 1
            try:
                out = entry.unit(n, spans)
            except RuntimeError as err:            # a unit that failed
                print(f"unit {n}: {err}", file=sys.stderr)
                failed += 1
            else:
                health.append(entry.health(out))
                if pick.random() * len(health) < 1.0:
                    kept = entry.keep(out)
                del out
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        r.window_s = ends[-1] - t0
        print("unit seconds " + " ".join(
            f"{b - a:.4f}" for a, b in zip(ends, ends[1:])), file=sys.stderr)
        r.units = n - failed
        r.audio_s = entry.audio_s
        failed += sum(entry.bad(h) for h in health)
        r.peak_bytes = (torch.cuda.max_memory_allocated(device) if cuda
                        else 0)
        mem_peak = max(setup_peak, r.peak_bytes) if cuda else 0
        if trace and cuda:
            step, steps = entry.profile_step()
            r.trace = profile.record(step, steps)
        found, limits = {}, check.load_limits(root, cell)
        if kept is not None:
            kept = entries.with_steps(entry, entry.read_back(kept))
            entry.release()
            if cuda:
                torch.cuda.empty_cache()
            hold = entries.step_iters(entries.gem_config(model))[0]
            found = check.numbers(kept, entry.reference(kept), hold)
    finally:
        entry.close()
    ok, table = check.judge(found, limits["limits"])
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = manifest.reader(root, m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(ok and failed == 0 and kept is not None),
              "attempted": n, "failed": failed, "metrics": metrics,
              "device": device_info(device, spec["chips"], mem_peak)}
    if trace and r.trace is not None:
        result["device"].update(busy_s=r.trace["busy_s"],
                                window_s=r.trace["window_s"])
        result["breakdown"] = profile.breakdown(r.trace)
    result["checks"] = table
    return result


def device_info(device, chips: int, peak: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not measured"
    return info


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from harness import manifest
    chips = manifest.resolve(ROOT, manifest.load(ROOT),
                             args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 start=start)
    bad = loaded_forbidden()
    if bad:
        print(f"the process has loaded {bad}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 1
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
