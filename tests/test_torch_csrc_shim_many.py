"""The E-step kernel at run-time J (csrc/estep_many.cu), compiled for the CPU.

The source is compiled with g++ against the stand-in headers of
tests/cuda_shim/ from a scratch copy rewritten as test_torch_csrc_shim.py
rewrites the others (launches, dynamic shared memory, the approximate
reciprocal's asm), and held against the plain version
(cuda_estep.estep_ref) through its C entry point. The fused route (a block
a segment of a row's 32-frame tiles, everything of a tile in shared
memory): at J = 17 (three leave-one-out runs, the last of one source), 20,
24 and 33, at one source, real and complex mixing, ranks 1, 2 and mixed,
noise injection and each flag, one frame and ragged frame edges (a last
quad of 1 to 3 frames, a last tile of fewer than 32); rows whose tiles
span several segments (the second pass adding their partials), with a
ragged last tile; and J = 30 at complex rank 2, the last J the fused
route takes there. The chunked route at J = 31, one past it: its chunk
budget, kChunkBytes, is cut in the scratch copy from 256 MiB to
SHIM_CHUNK_BYTES, so the chunks come at small planes (the frames kernel
and the sums kernel run several times, the later chunks adding to the
first's sums). The plan of each route (tiles, segments, chunks, shared
bytes) at the card's shapes, from the shape alone. xi has no sum in it
and must equal the plain version's bits; two launches give the same bits.
Bars: chip_smoke.py's (xi 2e-4, 3e-4 at rank 2; frame sums 5e-4 relative
with a floor of 1e-3 of the output's largest entry; loglik 1e-4). Built
with -ffp-contract=off, as nvcc builds with --fmad=false. A check of
indexing, masking, barriers and the order of the sums, not of the card
(tests/test_torch_cuda.py and chip_smoke.py phase 2 run it there). Skips
where g++ or -std=c++20 (std::barrier) is missing.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pyfasst_tpu_torch.ops import cuda_estep
from test_torch_csrc_shim import CSRC, ROOT, _rel, _t, translate

torch.set_num_threads(1)

SOURCES = ("estep_many.cu",)
CHUNK_BYTES = "kChunkBytes = 256ll << 20;"
SHIM_CHUNK_BYTES = 1 << 20


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    tmp = tmp_path_factory.mktemp("csrc_shim_many")
    probe = tmp / "probe.cpp"
    probe.write_text("#include <barrier>\nint main() { std::barrier<> b(1); "
                     "b.arrive_and_wait(); }\n")
    flags = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread"]
    if subprocess.run([gxx, *flags, "-o", str(tmp / "probe"), str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("needs a g++ with -std=c++20 and <barrier>")
    for src in (*SOURCES, "recip.cuh", "estep_general.cuh"):
        text = translate((CSRC / src).read_text())
        if src == "estep_many.cu":
            assert text.count(CHUNK_BYTES) == 1
            text = text.replace(CHUNK_BYTES,
                                f"kChunkBytes = {SHIM_CHUNK_BYTES}ll;")
        (tmp / src).write_text(text)
    out = tmp / "libshim_many.so"
    proc = subprocess.run([gxx, *flags, "-shared", "-x", "c++", "-I",
                           str(tmp), "-I", str(ROOT / "cuda_shim"),
                           *(str(tmp / s) for s in SOURCES), "-o", str(out)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.pyfasst_estep_many.argtypes = ([p] * 11 + [i] * 4
                                      + [ctypes.POINTER(i)] + [i] * 3 + [f]
                                      + [i] * 2 + [p])
    so.pyfasst_estep_many_workspace.argtypes = [i] * 6
    so.pyfasst_estep_many_workspace.restype = ctypes.c_longlong
    so.pyfasst_estep_many_plan.argtypes = [i] * 6 + [p]
    so.pyfasst_estep_many_info.argtypes = [i] * 5 + [p]
    return so


def _plan(lib, B, J, F, N, rmax, real):
    """The launch's plan: (route, frames a tile or chunk, segments or
    chunks, tiles a segment, blocks, shared bytes a block)."""
    out = (ctypes.c_longlong * 6)()
    assert lib.pyfasst_estep_many_plan(B, J, F, N, rmax, int(real), out) == 0
    return tuple(out)


def _inputs(J, ranks, real, B, F, N):
    rng = np.random.default_rng(J * 1000 + F * N + B)
    Rmax = max(ranks)
    x4 = _t(rng.standard_normal((B, 4, F, N)))
    v = _t(0.5 + 4 * rng.random((B, J, F, N)))
    A4 = np.zeros((B, J, F, 4 * Rmax))
    for j, R in enumerate(ranks):
        a = 0.7 * rng.standard_normal((B, F, 4 * R))
        if real:
            a[..., 1::2] = 0.0
        A4[:, j, :, :4 * R] = a
    sigma = _t(0.01 + 0.005 * rng.random((B, F)))
    return x4, v, _t(A4), sigma


def _run(lib, inp, ranks, real, ns, flag):
    """One launch through the C entry point with the scratch it asks for:
    its outputs, NaN wherever it wrote nothing."""
    x4, v, A4, sigma = inp
    B, J, F, N = v.shape
    Rmax = max(ranks)
    shapes = [(B, J, F, N), (B, J, F, 4 * Rmax),
              (B, J, J, F, 2 * Rmax * Rmax), (B, J, F, 4),
              (B, J, J, F, 2 * Rmax * Rmax), (B, F)]
    got = [torch.full(s, float("nan")) for s in shapes]
    words = lib.pyfasst_estep_many_workspace(B, J, F, N, Rmax, int(real))
    assert words >= 0
    ws = torch.full((words,), float("nan"))
    err = lib.pyfasst_estep_many(
        *(t.data_ptr() for t in (x4, v, A4, sigma, *got)),
        ws.data_ptr() if words else None, B, J, F, N,
        (ctypes.c_int * J)(*ranks), Rmax, int(real), int(ns),
        ctypes.c_float(1e-30), int(flag == "fast_recip"),
        int(flag == "no_ll"), None)
    assert err == 0
    return got


def _check(got, inp, ranks, real, ns, flag):
    want = cuda_estep.estep_ref(*inp, ranks, ns_inj=ns, real_cov=real,
                                no_ll=flag == "no_ll")
    for name, g, w, bar in zip(("xi", "txs", "tss", "t4", "t7"), got, want,
                               (3e-4 if max(ranks) == 2 else 2e-4,)
                               + (5e-4,) * 4):
        assert bool(torch.isfinite(g).all()), name     # every word written
        assert _rel(g, w) <= bar, name
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)
    for g, w in zip(got[1:5], want[1:5]):              # padding and zeros
        assert torch.equal(g[w == 0], w[w == 0])
    if flag != "fast_recip":
        assert torch.equal(got[0], want[0])            # xi: no sum in it


_MIXED17 = (1, 2) * 8 + (1,)
# (J, ranks, real_cov, ns_inj, flag, B, F, N)
CASES = [(17, (1,) * 17, True, False, "", 1, 2, 33),
         (17, (2,) * 17, False, False, "", 1, 1, 70),
         (17, _MIXED17, False, False, "no_ll", 1, 2, 31),
         (17, (1,) * 17, False, True, "fast_recip", 2, 1, 1),
         (17, (2,) * 17, True, True, "", 1, 1, 45),
         (17, _MIXED17, True, True, "no_ll", 1, 1, 6),
         (1, (1,), True, False, "", 1, 3, 33),
         (1, (2,), False, True, "", 1, 2, 40),
         (20, (1,) * 20, True, False, "", 1, 1, 63),
         (24, (1,) * 24, False, False, "fast_recip", 1, 1, 65),
         (24, (2, 1) * 12, False, True, "", 1, 1, 34),
         (33, (1,) * 33, True, False, "no_ll", 1, 1, 37)]


@pytest.mark.parametrize("J,ranks,real,ns,flag,B,F,N", CASES)
def test_many_source_matches_plain_version(lib, J, ranks, real, ns, flag, B,
                                           F, N):
    inp = _inputs(J, ranks, real, B, F, N)
    _check(_run(lib, inp, ranks, real, ns, flag), inp, ranks, real, ns, flag)


@pytest.mark.parametrize("case", [CASES[2], CASES[5], CASES[10]])
def test_many_source_twice_gives_the_same_bits(lib, case):
    J, ranks, real, ns, flag, B, F, N = case
    inp = _inputs(J, ranks, real, B, F, N)
    got = _run(lib, inp, ranks, real, ns, flag)
    for g, a in zip(got, _run(lib, inp, ranks, real, ns, flag)):
        assert torch.equal(g, a)


# The plan, from the shape alone. Fused (route 0): tiles of 32 frames,
# S = 2048 // (B F) segments a row, at most one per 4 tiles: phase 19
# (d)'s path (1, 20, 513, 863), 27 tiles, 3 segments of 9, 1,539 blocks
# of 24,824 shared bytes; B = 8 at complex rank 2, one segment of 27,
# 4,104 blocks of 64,424. The last J the fused route takes at each rank
# and mixing (60 real rank 1, 51 complex rank 1, 37 real rank 2, 30
# complex rank 2: the tile's features, the row's constants and totals and
# the owner table in at most 113 KB, so that two blocks share an SM), and
# one past it, chunked (route 1: frames a chunk within SHIM_CHUNK_BYTES of
# a clip's features here).
FUSED_SMEM = 233472 // 2 - 1024
FUSED_LAST = {(1, True): 60, (1, False): 51, (2, True): 37, (2, False): 30}


@pytest.mark.parametrize("shape,rmax,real,plan", [
    ((1, 20, 513, 863), 1, True, (0, 32, 3, 9, 1539, 24824)),
    ((8, 20, 513, 863), 2, False, (0, 32, 1, 27, 4104, 64424)),
    ((1, 17, 1, 300), 2, False, (0, 32, 2, 5, 2, None)),
    ((2, 20, 1, 271), 1, True, (0, 32, 2, 5, 4, None))])
def test_many_fused_plan(lib, shape, rmax, real, plan):
    got = _plan(lib, *shape, rmax, real)
    assert got[:5] == plan[:5] and got[5] == (plan[5] or got[5])
    B, J, F, N = shape
    words = lib.pyfasst_estep_many_workspace(B, J, F, N, rmax, int(real))
    # the partials of a row's segments, none at one segment
    assert (words == 0) == (plan[2] == 1) and words >= 0


@pytest.mark.parametrize("rmax,real", sorted(FUSED_LAST))
def test_many_route_crossover(lib, rmax, real):
    J = FUSED_LAST[rmax, real]
    last = _plan(lib, 1, J, 513, 863, rmax, real)
    past = _plan(lib, 1, J + 1, 513, 863, rmax, real)
    assert last[0] == 0 and last[5] <= FUSED_SMEM
    assert past[0] == 1 and past[1] % 32 == 0 and past[5] == 0


# rows whose tiles span two segments (the second pass adds the partials in
# segment order), the last tile ragged: 300 frames = 9 tiles and 12
# frames (segments of 5 and 5 tiles), 271 = 8 tiles and 15 (5 and 4)
SEGMENTED = [(17, (2,) * 17, False, False, "", 1, 1, 300),
             (20, (1,) * 20, True, False, "no_ll", 2, 1, 271)]


@pytest.mark.parametrize("J,ranks,real,ns,flag,B,F,N", SEGMENTED)
def test_many_source_over_segments(lib, J, ranks, real, ns, flag, B, F, N):
    assert _plan(lib, B, J, F, N, max(ranks), real)[2] == 2
    inp = _inputs(J, ranks, real, B, F, N)
    _check(_run(lib, inp, ranks, real, ns, flag), inp, ranks, real, ns, flag)


def test_many_segments_twice_give_the_same_bits(lib):
    J, ranks, real, ns, flag, B, F, N = SEGMENTED[1]
    inp = _inputs(J, ranks, real, B, F, N)
    got = _run(lib, inp, ranks, real, ns, flag)
    for g, a in zip(got, _run(lib, inp, ranks, real, ns, flag)):
        assert torch.equal(g, a)


# complex rank 2 at the crossover: J = 30 fused, J = 31 chunked (F = 8
# rows of 532 features a frame: 32-frame chunks within 1 MiB, two of them,
# the second of one frame)
@pytest.mark.parametrize("J,route,F,N", [(30, 0, 1, 33), (31, 1, 8, 33)])
def test_many_source_at_the_crossover(lib, J, route, F, N):
    ranks = (2,) * J
    plan = _plan(lib, 1, J, F, N, 2, False)
    assert plan[0] == route and plan[2] == (1 if route == 0 else 2)
    inp = _inputs(J, ranks, False, 1, F, N)
    _check(_run(lib, inp, ranks, False, True, ""), inp, ranks, False, True,
           "")


def test_many_refuses_what_it_cannot_take(lib):
    out = (ctypes.c_int * 4)()
    for which in (0, 1, 2, 3):
        for rmax in (1, 2):
            assert lib.pyfasst_estep_many_info(which, 20, rmax, 0, 1,
                                               out) == 0
    assert lib.pyfasst_estep_many_info(4, 20, 1, 0, 0, out) != 0
    assert lib.pyfasst_estep_many_info(0, 20, 3, 0, 0, out) != 0
    # the fused kernel's info at a J it does not take
    assert lib.pyfasst_estep_many_info(2, 31, 2, 0, 0, out) != 0
    plan = (ctypes.c_longlong * 6)()
    assert lib.pyfasst_estep_many_plan(1, 4097, 1, 1, 1, 1, plan) != 0
    assert lib.pyfasst_estep_many_plan(1, 17, 0, 1, 1, 1, plan) != 0
    assert lib.pyfasst_estep_many_workspace(1, 4097, 1, 1, 1, 1) == -1
    assert lib.pyfasst_estep_many_workspace(1, 17, 1, 1, 3, 1) == -1
    assert lib.pyfasst_estep_many_workspace(0, 17, 1, 1, 1, 1) == -1
    assert lib.pyfasst_estep_many_workspace(1, 4096, 1, 1, 1, 1) > 0
    # a rank past the launch's Rmax is refused before any launch
    inp = _inputs(17, (1,) * 17, True, 1, 1, 5)
    got = [torch.zeros(1) for _ in range(7)]
    err = lib.pyfasst_estep_many(
        *(t.data_ptr() for t in inp), *(t.data_ptr() for t in got), 1, 17, 1,
        5, (ctypes.c_int * 17)(*((2,) + (1,) * 16)), 1, 1, 0,
        ctypes.c_float(1e-30), 0, 0, None)
    assert err != 0
