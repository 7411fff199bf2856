"""CPU tests of the benchmark harness (benchmark/), and its card tests
(marker `cuda`, skipped without a card):

    python -m pytest benchmark/tests -q            # here, ~2 min
    python -m pytest benchmark/tests -q -m cuda    # on the card

The small runs take each cell's own files with fewer iterations, shorter
clips and smaller pools (`tiny`)."""
from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "benchmark")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("stereo_nmf_end1e-3.b8", "stereo_nmf_fused_end1e-3.b8")
# The host API's entry (harness/entries.HostAPI), in no cell of
# BENCHMARK.json yet: its tests add it to a copy as a later cell would,
# as data, with the unfused cell's limits (wav in place of images).
HOST = "stereo_nmf_end1e-3.host_b1"


def host_checkout(tmp_path: Path) -> Path:
    """A copy of the benchmark with the cell HOST added: the unfused
    configuration under benchmark/traffic/host_b1.json."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": HOST, "config": "stereo_nmf_end1e-3",
                               "traffic": "host_b1", "chips": 1,
                               "why": "the host API"})
    bench["end_to_end"].append({"name": "xrt.host", "unit": "audio-s/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": [HOST]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    lim = json.loads((ROOT / "benchmark/limits" / f"{CELLS[0]}.json")
                     .read_text())
    lim["limits"].pop("images")
    lim["limits"]["wav"] = 0.5
    (root / "benchmark/limits" / f"{HOST}.json").write_text(json.dumps(lim))
    return root


def tiny(cell: str, root: Path = ROOT, niter: int = 100,
         seconds: float = 0.3):
    """(model, traffic) of `cell` at a size the CPU runs in a second or
    two: niter iterations, clips of `seconds`, two clips a call. The
    spatial hold keeps its 50 iterations."""
    from harness import manifest
    spec = manifest.resolve(root, manifest.load(root), cell)
    model, mix = copy.deepcopy(spec["model"]), copy.deepcopy(spec["traffic"])
    g = model["gem"]
    g["spatial_hold_frac"] = g["spatial_hold_frac"] * g["niter"] / niter
    g["niter"] = niter
    mix["clips"]["seconds"] = seconds
    if mix["entry"] == "batch":
        mix["batch"], mix["pool"] = 2, 4
    else:
        mix["pool"] = 2
    return model, mix


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
