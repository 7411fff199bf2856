"""On the card, at each cell's own size: the program's run reads within
the cell's limits and the control (the reference in the program's place,
its fit in float32 with TF32 products and its state held in bfloat16, its
Wiener filter in bfloat16) comes out as not correct. `calibrate.py` reads
the same over a dozen seeds for the limits."""
from __future__ import annotations

import pytest

from conftest import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    import calibrate
    from harness import check
    limits = check.load_limits(ROOT, cell)
    got = calibrate.readings(cell, 977, True)
    ok, table = check.judge(got["program"], limits["limits"])
    assert ok, table
    ok, table = check.judge(got["control"], limits["limits"])
    assert not ok, table
