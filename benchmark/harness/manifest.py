"""BENCHMARK.json and the files it names, resolved by name.

A cell (an entry of "workloads") names a configuration, whose JSON file the
configuration's "file" gives, and a traffic mix, benchmark/traffic/
<traffic>.json. Every metric, end-to-end and per-layer, is a reader in
benchmark/metrics/<name>.py. A cell reports each end-to-end metric whose
"workloads" lists it (all cells without the key) and each per-layer
metric whose "workloads" lists it (without the key: every cell that
reports the metric it moves).
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: Path, bench: dict, cell: str) -> dict:
    """{"cell", "chips", "config", "model", "traffic", "end_to_end",
    "per_layer"} of the workload named `cell`; KeyError for a name the
    manifest lacks."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"(there are {sorted(work)})")
    w = work[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"cell": cell, "chips": w["chips"], "config": cfg,
            "model": _read_json(root / cfg["file"]),
            "traffic": _read_json(root / "benchmark" / "traffic"
                                  / f"{w['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def reader(root: Path, name: str):
    """The read(readings) function of benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
