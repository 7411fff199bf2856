"""The copy-and-edit helpers behind the card's tuning tools.

kernel_compare.py's make_copy copies a tree's package (without its builds)
with text edits to its CUDA sources; --variant, tools/wide_probe.py
(a copy that stops after phase 1) and tools/many_probe.py routes (a copy
whose fused route takes no shape) build and time such copies on the card.
These tests hold the helper to its contract and each probe's edits to the
sources they edit, so that a source change that moves an edited line
shows here, on the CPU, rather than in a chip call.
"""
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "pyfasst_tpu_torch" / "csrc"


def _load(path):
    spec = importlib.util.spec_from_file_location(f"tools_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KC = _load(REPO / "kernel_compare.py")


def test_make_copy_replaces_one_occurrence(tmp_path):
    old = "constexpr int kGenWarps = 4;"
    new = "constexpr int kGenWarps = 8;"
    dest = KC.make_copy(tmp_path / "v", [("estep_general.cuh", old, new)])
    text = (dest / KC.PKG / "csrc" / "estep_general.cuh").read_text()
    assert new in text and old not in text
    assert (dest / KC.PKG / "ops" / "cuda_estep.py").is_file()
    assert not (dest / KC.PKG / "_build").exists()
    # the tree's own source is left as it was
    assert old in (CSRC / "estep_general.cuh").read_text()


@pytest.mark.parametrize("old", ["no such text in the header",
                                 "#pragma once"])
def test_make_copy_refuses_text_not_found_once(tmp_path, old):
    text = (CSRC / "estep_general.cuh").read_text()
    if old == "#pragma once":        # a line that occurs once: doubled
        (tmp_path / "tree" / KC.PKG / "csrc").mkdir(parents=True)
        (tmp_path / "tree" / KC.PKG / "csrc" / "estep_general.cuh") \
            .write_text(text + "\n" + old + "\n")
        tree = tmp_path / "tree"
    else:
        tree = REPO
    with pytest.raises(SystemExit, match="not once"):
        KC.make_copy(tmp_path / "v", [("estep_general.cuh", old, "")], tree)


def test_wide_probe_edits_each_occur_once(tmp_path):
    wp = _load(REPO / "tools" / "wide_probe.py")
    edits = [(wp.HEADER, o, n) for o, n in wp.PHASE1_EDITS + wp.RENAME]
    dest = KC.make_copy(tmp_path / "phase1", edits)
    text = (dest / KC.PKG / "csrc" / wp.HEADER).read_text()
    assert text.count("if (false)") == len(wp.PHASE1_EDITS)


def test_many_probe_route_edit_occurs_once(tmp_path):
    mp = _load(REPO / "tools" / "many_probe.py")
    dest = KC.make_copy(tmp_path / "routes", [mp.ROUTE_EDIT])
    text = (dest / KC.PKG / "csrc" / "estep_many.cu").read_text()
    assert text.count(mp.ROUTE_EDIT[2]) == 1


def test_wide_probe_copies_a_tree_from_before_the_wide_kernel(tmp_path):
    """A parent tree's header has FRAMES' owner tests only: the probe's
    phase-1 copy switches those off and leaves the rest alone."""
    wp = _load(REPO / "tools" / "wide_probe.py")
    text = (CSRC / wp.HEADER).read_text()
    for old, _ in wp.PHASE1_EDITS[3:]:          # the WIDE kernel's three
        text = text.replace(old, "")
    tree = tmp_path / "parent"
    (tree / KC.PKG / "csrc").mkdir(parents=True)
    (tree / KC.PKG / "csrc" / wp.HEADER).write_text(text)
    dirs = wp.copies(tree, tmp_path / "probe")
    got = (dirs["phase1"] / KC.PKG / "csrc" / wp.HEADER).read_text()
    assert got.count("if (false)") == 3
    assert "allowed_phase1[" in got
    assert (dirs["whole"] / KC.PKG / "csrc" / wp.HEADER).read_text() == text
