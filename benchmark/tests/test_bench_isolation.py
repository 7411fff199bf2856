"""The benchmark runs the port alone: no module it loads has the top-level
name jax, jaxlib, flax or pyfasst_tpu (compared whole: the port's own name
begins with the JAX package's); and its command refuses to run without a
card, printing no result."""
from __future__ import annotations

import json
import subprocess
import sys

from conftest import CELLS, ROOT

DRIVE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
from conftest import tiny
import run
for cell in {cells!r}:
    model, mix = tiny(cell)
    assert run.run(cell, 5, 0.2, True, device="cpu", model=model,
                   traffic_mix=mix)["correct"]
import calibrate, harness.counts
harness.counts.gem_iteration_ops(1, 2, 9, 7, 2, 0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_the_process():
    code = DRIVE.format(bench=str(ROOT / "benchmark"), root=str(ROOT),
                        tests=str(ROOT / "benchmark" / "tests"),
                        cells=list(CELLS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pyfasst_tpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pyfasst_tpu"}


def test_names_are_compared_whole(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "pyfasst_tpu_torch.fake", object())
    assert "pyfasst_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pyfasst_tpu.ops", object())
    assert run.loaded_forbidden() == ["pyfasst_tpu"]


def test_command_refuses_without_a_card():
    """Here torch sees no card: exit 2, nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr
