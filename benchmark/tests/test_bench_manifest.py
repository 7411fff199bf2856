"""BENCHMARK.json resolves by name and keeps to the benchmark's format;
a configuration, a traffic mix and a metric added as new files are picked
up without an edit to a file that is there."""
from __future__ import annotations

import json
import shutil

import pytest

from conftest import CELLS, ROOT, tiny
from harness import check, manifest

BENCH = manifest.load(ROOT)


def test_every_name_resolves():
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    for cell in CELLS:
        spec = manifest.resolve(ROOT, BENCH, cell)
        assert spec["model"]["sources"] == 2
        assert spec["traffic"]["entry"] in ("batch", "host_api")
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        assert check.load_limits(ROOT, cell)
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(manifest.reader(ROOT, m["name"]))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (names, [w["name"] for w in BENCH["workloads"]],
                  [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))
        assert all(manifest.NAME.match(n) for n in group)
    for w in BENCH["workloads"]:
        assert manifest.NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 0 < len(w["why"]) <= 200
    for m in metrics:
        assert manifest.UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}


def test_added_files_are_picked_up(tmp_path):
    """A new configuration, traffic mix, metric and cell, added as files
    and new entries in a copy of the benchmark, run without an edit to
    any file already there."""
    from run import run
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    model, mix = tiny("stereo_nmf_end1e-3.b8")
    model["nmf_rank"] = 4
    (root / "benchmark/configs/stereo_nmf_k4.json").write_text(
        json.dumps(model))
    (root / "benchmark/traffic/tiny_b2.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/units_done.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    (root / "benchmark/limits/stereo_nmf_k4.tiny.json").write_text(
        json.dumps({"limits": {"loglik": 1.0}}))
    bench["configs"].append({"name": "stereo_nmf_k4", "source": "test",
                             "file": "benchmark/configs/stereo_nmf_k4.json",
                             "reduced": ["nmf_rank"], "why": "test"})
    bench["workloads"].append({"name": "stereo_nmf_k4.tiny",
                               "config": "stereo_nmf_k4",
                               "traffic": "tiny_b2", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "units_done", "unit": "1",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["stereo_nmf_k4.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run("stereo_nmf_k4.tiny", 3, 0.5, False, device="cpu", root=root)
    assert res["metrics"]["units_done"]["value"] == res["attempted"] >= 1
    assert "xrt.batch" not in res["metrics"]
    assert res["correct"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("cell", CELLS)
def test_limits_name_numbers_the_check_makes(cell):
    """Each limit names a number of check.numbers, the fit's and the
    images' both held, every limit a small positive share."""
    spec = check.load_limits(ROOT, cell)
    assert set(spec["limits"]) <= set(check.NUMBERS)
    assert {"loglik_hold", "step_mixing", "images"} <= set(spec["limits"])
    assert all(0 < v < 1 for v in spec["limits"].values())
