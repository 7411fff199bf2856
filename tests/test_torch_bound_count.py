"""The operation count behind the general E-step's bound and float32 floor.

chip_smoke.general_ops counts the operations of one call of the general
E-step kernel's function: its plain version's (cuda_estep.estep_ref,
counted by chip_smoke.count_ops as it runs), with the frame sums (Txs,
Tss, T7) counted as the function needs them (_frame_sums(need=True))
rather than in estep_ref's forms (_frame_sums(need=False)). These tests
hold the replica of estep_ref's forms to estep_ref itself (a copy of its
source without its frame sums counts exactly that much less), the
function's count to a count by hand, and the count on meta tensors
(chip_smoke.bound_table, no card) to the count on real ones. CPU only,
small shapes.
"""
import importlib.util
import inspect
from pathlib import Path

import pytest
import torch

from pyfasst_tpu_torch.ops import cuda_estep as ce

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_count",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()

# name: (B, J, F, N, ranks, real_cov, ns_inj)
CASES = {
    "real_r1_J3": (2, 3, 5, 7, (1,) * 3, True, False),
    "complex_r1_J3": (2, 3, 5, 7, (1,) * 3, False, False),
    "complex_r2_J4": (1, 4, 5, 9, (2,) * 4, False, False),
    "mixed_ns_J4": (1, 4, 5, 9, (1, 2, 2, 1), False, True),
    "real_r2_ns_J5": (1, 5, 3, 6, (2,) * 5, True, True),
    "real_r1_J9": (1, 9, 3, 6, (1,) * 9, True, False),
}


def _inputs(B, J, F, N, ranks, real):
    return CS._general_inputs(B, J, F, N, ranks, real, seed=1, device="cpu")


def _estep_ref_without_frame_sums():
    """estep_ref with its Txs loop and its Tss / T7 loops taken out of its
    source: the same arithmetic but the frame sums'."""
    src = inspect.getsource(ce.estep_ref)
    txs = "        for r in range(ranks[j]):\n            cw = _cconj(w[j][r])"
    pairs = "    for j in range(J):\n        for k in range(J):\n            vv"
    end = "    tss = torch.zeros("
    ret = "    return xi, txs, tss, t4, t7, ll"
    for mark in (txs, pairs, end, ret):
        assert src.count(mark) == 1, f"estep_ref's source lacks {mark!r}"
    src = src[:src.index(txs)] + src[src.index(end):]
    src = src[:src.index(pairs)] + src[src.index(ret):]
    scope = dict(vars(ce))
    exec(src.replace("def estep_ref(", "def estep_cut("), scope)
    return scope["estep_cut"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_frame_sum_replica_counts_estep_refs_frame_sums(name):
    B, J, F, N, ranks, real, ns = CASES[name]
    inp = _inputs(B, J, F, N, ranks, real)
    kw = dict(ns_inj=ns, real_cov=real)
    whole = CS.count_ops(ce.estep_ref, *inp, ranks, **kw)
    rest = CS.count_ops(_estep_ref_without_frame_sums(), *inp, ranks, **kw)
    assert whole - rest == CS._frame_sums(ce, inp, ranks, False, **kw)
    need = CS._frame_sums(ce, inp, ranks, True, **kw)
    assert 0 < need < whole - rest
    assert CS.general_ops(inp, ranks, **kw) == whole - (whole - rest) + need


@pytest.mark.parametrize("real", [True, False])
def test_needed_frame_sums_by_hand(real):
    """J = 2, rank 1: per frame, u = v w (2 a source) and y = v z (2 or 4
    a source); Txs x conj(u) in both channels (2 x (6 + 2) a source); Tss
    u_j conj(u_k) for j <= k (3 x (6 + 2)); T7's sums v_j y_k for j != k
    (2 x (2 or 4) x 2). Per row, T7 = A^H times those sums: (2 x 1 + 1)
    or (2 x 6 + 2) for each of the two (j != k)."""
    B, F, N = 2, 3, 5
    inp = _inputs(B, 2, F, N, (1, 1), real)
    zw = 2 if real else 4
    per_frame = 2 * (2 + zw) + 2 * 16 + 3 * 8 + 2 * zw * 2
    per_row = 2 * (3 if real else 14)
    got = CS._frame_sums(ce, inp, (1, 1), True, real_cov=real)
    assert got == per_frame * B * F * N + per_row * B * F


@pytest.mark.parametrize("name", ["complex_r1_J3", "mixed_ns_J4",
                                  "real_r1_J9"])
def test_count_on_meta_tensors_equals_count_on_tensors(name):
    B, J, F, N, ranks, real, ns = CASES[name]
    inp = _inputs(B, J, F, N, ranks, real)
    meta = [torch.empty(t.shape, device="meta") for t in inp]
    kw = dict(ns_inj=ns, real_cov=real)
    assert CS.general_ops(meta, ranks, **kw) == CS.general_ops(inp, ranks,
                                                               **kw)
