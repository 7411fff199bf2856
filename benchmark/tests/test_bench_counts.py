"""The frozen counts (benchmark/harness/counts.py) reproduce the figures
they were copied from, on meta tensors."""
from __future__ import annotations

import json

import pytest

from harness import counts


def test_estep_bound_is_chip_smokes_row_1a(capsys):
    """chip_smoke.bound_table()'s bound of the E-step at the bench shape
    (8, 2, 513, 863), real rank-1 mixing: the same operations, bytes,
    bound and limiting resource (PERF.md row 1a: 0.0340 ms by bytes)."""
    import chip_smoke
    chip_smoke.bound_table(shapes=(("1a", 8, 2, 513, 863, (1, 1), True,
                                    False),))
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    b_s, b_by, nbytes, ops = counts.estep_bound(8, 2, 513, 863)
    assert row["gop"] == round(ops / 1e9, 4)
    assert row["mb"] == round(nbytes / 1e6, 2)
    assert row["bound_ms"] == round(b_s * 1e3, 4) == 0.034
    assert row["bound_by"] == b_by == "bytes"


def test_spectral_bound_is_rows_2_and_3():
    """fb_stats and tw_stats at the bench shape, K = 8: 29.6 and 29.9 MB,
    each bound by bytes (PERF.md rows 2 and 3: 0.0088 and 0.0089 ms)."""
    s, nbytes, ops = counts.spectral_bound(8, 2, 513, 863, 8)
    plane = 8 * 2 * 513 * 863 * 4                   # xi, read by both
    fb = plane + 4 * (8 * 2 * (513 * 8 + 8 * 863) + 16 + 2 * 8 * 2 * 513 * 8)
    tw = plane + 4 * (8 * 2 * (513 * 8 + 8 * 863) + 16 + 2 * 8 * 2 * 8 * 863)
    assert (round(fb / 1e6, 1), round(tw / 1e6, 1)) == (29.6, 29.9)
    assert nbytes == fb + tw
    assert s == pytest.approx(nbytes / counts.HBM_BYTES_PER_S, rel=1e-12)
    assert ops / counts.FP32_OPS_PER_S < s


def test_gem_iteration_ops_add_up():
    ops = counts.gem_iteration_ops(2, 2, 33, 40, 4,
                                   counts.estep_bound(2, 2, 33, 40)[3])
    parts = {k: v for k, v in ops.items() if k != "total"}
    assert all(v > 0 for v in parts.values())
    assert ops["total"] == sum(parts.values())
    # the powers v = FB TW: a product of (F, K) by (K, N) a source and clip
    assert ops["powers"] == 2 * 2 * 2 * 33 * 4 * 40


@pytest.mark.parametrize("K", (4, 8))
def test_spectral_update_count_scales_with_rank(K):
    """Each source's FB and TW updates take six products of 2 F K N
    operations (V, both statistics of each factor, V refreshed twice)."""
    B, J, F, N = 1, 2, 17, 23
    ops = counts.gem_iteration_ops(B, J, F, N, K, 0)["spectral"]
    assert ops > J * 6 * 2 * F * K * N
