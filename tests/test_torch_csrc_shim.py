"""The CUDA sources of the port, compiled for the CPU and run at ragged shapes.

csrc/estep.cu, csrc/spectral.cu and the general E-step kernel
(csrc/estep_general.cuh through csrc/estep_j{2..8}.cu) are compiled with
g++ against the stand-in headers of tests/cuda_shim/ (threads, barriers
and shuffles on std::thread; one block at a time), from a scratch copy in
which

    kernel<<<grid, block, smem, stream>>>(args);   ->  shim::launch(...)
    extern __shared__ ... float name[];            ->  shim::dynamic_shared()
    recip.cuh's rcp.approx asm                     ->  1 / x

and estep_r1_real, the general E-step (J = 2 to 8, real and complex, ranks
1, 2 and mixed, noise injection and each flag), tw_stats and fb_stats are
held against their plain PyTorch versions at shapes that cross every tile
edge of the kernels (one frame, 31 and 33 frames, fewer rows than a batch,
two rows more than a chunk, K below, at and above KMAX; past K = 32 the
tiled kernel's 16-row blocks, 64-position tiles, register budget of 64
components, chunks of 64 past it and the split of the contracted axis).
Built with -ffp-contract=off, as nvcc builds with --fmad=false. It is a
check of indexing, masking, barriers and the order of the sums, not of
the card: the kernels' agreement on the card is held by
tests/test_torch_cuda.py and chip_smoke.py. The shim's cp.async copies at
once, so a missing __pipeline_wait_prior or a barrier that does not cover
a copy in flight shows only on the card. Skips where g++ or -std=c++20
(std::barrier) is missing.

Bars: chip_smoke.py's (xi 2e-4, frame sums 5e-4 relative with a floor of
1e-3 of the output's largest entry, loglik 1e-4; the spectral kernels
rtol 2e-5). xi has no sum in it and must equal the plain version's bit
for bit with exact divides.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent
CSRC = ROOT.parent / "pyfasst_tpu_torch" / "csrc"
SOURCES = ("estep.cu", "spectral.cu") + tuple(
    f"estep_j{J}.cu" for J in cuda_estep.GENERAL_J)
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<\w+>)?)<<<(.+?)>>>\((.*?)\);", re.S)
_DYNAMIC = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];")
_ASM = re.compile(r'asm\("rcp\.approx\.f32[^;]*;[^;]*;')


def translate(text: str) -> str:
    """A CUDA source as the C++ that g++ compiles against the shim."""
    text = _LAUNCH.sub(r"shim::launch(\2, [&] { \1(\3); });", text)
    text = _DYNAMIC.sub(r"float* \1 = shim::dynamic_shared();", text)
    return _ASM.sub("r = 1.0f / x;", text)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    tmp = tmp_path_factory.mktemp("csrc_shim")
    probe = tmp / "probe.cpp"
    probe.write_text("#include <barrier>\nint main() { std::barrier<> b(1); "
                     "b.arrive_and_wait(); }\n")
    flags = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-pthread"]
    if subprocess.run([gxx, *flags, "-o", str(tmp / "probe"), str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("needs a g++ with -std=c++20 and <barrier>")
    for src in (*SOURCES, "recip.cuh", "estep_general.cuh"):
        (tmp / src).write_text(translate((CSRC / src).read_text()))
    out = tmp / "libshim.so"
    # one g++ per source, all started together, then the link
    inc = ["-I", str(tmp), "-I", str(ROOT / "cuda_shim")]
    jobs = [subprocess.Popen([gxx, *flags, "-c", "-x", "c++", *inc,
                              str(tmp / s), "-o", str(tmp / f"{s}.o")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for s in SOURCES]
    for job in jobs:
        log = job.communicate()[0]
        assert job.returncode == 0, log[-4000:]
    proc = subprocess.run([gxx, *flags, "-shared", "-o", str(out),
                           *(str(tmp / f"{s}.o") for s in SOURCES)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.pyfasst_estep_r1_real.argtypes = [p] * 10 + [i] * 4 + [f] + [i] * 2 + [p]
    for name in ("pyfasst_fb_stats", "pyfasst_tw_stats"):
        getattr(so, name).argtypes = [p] * 7 + [i] * 5 + [p]
        getattr(so, f"{name}_workspace").argtypes = [i] * 5
        getattr(so, f"{name}_workspace").restype = ctypes.c_longlong
    so.pyfasst_estep_r1_real_info.argtypes = [i, p]
    for J in cuda_estep.GENERAL_J:
        getattr(so, f"pyfasst_estep_j{J}").argtypes = (
            [p] * 10 + [i] * 7 + [f] + [i] * 2 + [p])
        getattr(so, f"pyfasst_estep_j{J}_info").argtypes = [i] * 3 + [p]
    so.pyfasst_tw_stats_info.argtypes = [i, i, p]
    so.pyfasst_fb_stats_info.argtypes = [i, p]
    return so


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _rel(got, want):
    floor = 1e-3 * float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / (want.abs() + floor)).max())


# N = 1, 31, 33: one frame, one short of and one past a warp's tile of 32;
# 45 and 129: a second tile and a fifth (a second turn of warp 0), ragged;
# 200: every warp twice, the last tile ragged; 20011: a long ragged row,
# as the ERBlet plane's (F = 48, N = 98304) gives each lane hundreds of
# frames to sum before the butterfly
@pytest.mark.parametrize("B,J,F,N,flag", [
    (1, 2, 3, 1, ""), (1, 2, 2, 31, "fast_recip"), (2, 2, 2, 33, "no_ll"),
    (1, 2, 3, 45, ""), (1, 2, 2, 200, ""), (1, 2, 1, 129, "fast_recip"),
    (1, 3, 2, 7, ""), (1, 3, 2, 33, "fast_recip"), (1, 3, 2, 70, "no_ll"),
    (2, 3, 1, 129, ""), (1, 2, 3, 20011, "")])
def test_estep_r1_real_source_matches_plain_version(lib, B, J, F, N, flag):
    rng = np.random.default_rng(B * F * N + J)
    x4 = _t(rng.standard_normal((B, 4, F, N)))
    v = _t(0.5 + 4 * rng.random((B, J, F, N)))
    A = _t(0.3 + rng.random((B, J, F, 2)))
    sigma = _t(0.01 + 0.005 * rng.random((B, F)))
    shapes = [(B, J, F, N), (B, J, F, 4), (B, J, J, F, 2), (B, J, F, 4),
              (B, J, J, F, 2), (B, F)]
    got = [torch.full(s, float("nan")) for s in shapes]
    err = lib.pyfasst_estep_r1_real(
        *(t.data_ptr() for t in (x4, v, A, sigma, *got)), B, J, F, N,
        ctypes.c_float(1e-30), int(flag == "fast_recip"),
        int(flag == "no_ll"), None)
    assert err == 0
    want = cuda_estep.estep_r1_real_ref(x4, v, A, sigma,
                                        no_ll=flag == "no_ll")
    for name, g, w, bar in zip(("xi", "txs", "tss", "t4", "t7"), got, want,
                               (2e-4,) + (5e-4,) * 4):
        assert bool(torch.isfinite(g).all()), name     # every word written
        assert _rel(g, w) <= bar, name
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)
    if flag != "fast_recip":
        assert torch.equal(got[0], want[0])            # xi: no sum in it
    # the words the kernel writes from a mirrored sum or as a constant
    tss, t4, t7 = got[2], got[3], got[4]
    assert torch.equal(tss[..., 0], tss[..., 0].transpose(1, 2))
    assert torch.equal(tss[..., 1], -tss[..., 1].transpose(1, 2))
    for g, w in ((tss, want[2]), (t4, want[3]), (t7, want[4])):
        assert torch.equal(g[w == 0], w[w == 0])
    assert not bool((t4[..., 1:] != 0).any() or (t7[..., 1] != 0).any())


# (J, ranks, real_cov, ns_inj, flag, B, F, N): every J the general kernel
# is built for, real and complex, ranks 1, 2 and mixed, noise injection and
# each flag, at frame counts that cross its 32-frame tiles (1, 31, 33, 45,
# 70, 129); J = 5 real rank 1 is `separate --sources 5`'s E-step, J = 8
# rank 2 the largest: 832 sums in 26 chunks of the tile, a 48 KB buffer
GENERAL = [(2, (1, 1), False, False, "", 1, 3, 33),
           (3, (2, 1, 2), True, True, "fast_recip", 1, 2, 45),
           (4, (2, 2, 2, 2), False, True, "", 2, 2, 31),
           (5, (1,) * 5, True, False, "", 1, 3, 33),
           (5, (1, 2, 2, 1, 2), False, False, "no_ll", 1, 2, 70),
           (5, (1,) * 5, False, True, "fast_recip", 1, 2, 1),
           (6, (2,) * 6, True, True, "", 1, 2, 45),
           (7, (1, 1, 2, 1, 1, 2, 1), False, False, "", 1, 2, 129),
           (8, (1,) * 8, True, False, "", 2, 2, 33),
           (8, (2,) * 8, False, False, "", 1, 3, 70),
           (8, (2,) * 8, False, True, "no_ll", 1, 2, 33)]


@pytest.mark.parametrize("J,ranks,real,ns,flag,B,F,N", GENERAL)
def test_general_estep_source_matches_plain_version(lib, J, ranks, real, ns,
                                                    flag, B, F, N):
    rng = np.random.default_rng(J * 1000 + F * N)
    Rmax = max(ranks)
    x4 = _t(rng.standard_normal((B, 4, F, N)))
    v = _t(0.5 + 4 * rng.random((B, J, F, N)))
    A4 = np.zeros((B, J, F, 4 * Rmax))
    for j, R in enumerate(ranks):
        a = 0.7 * rng.standard_normal((B, F, 4 * R))
        if real:
            a[..., 1::2] = 0.0
        A4[:, j, :, :4 * R] = a
    A4 = _t(A4)
    sigma = _t(0.01 + 0.005 * rng.random((B, F)))
    shapes = [(B, J, F, N), (B, J, F, 4 * Rmax),
              (B, J, J, F, 2 * Rmax * Rmax), (B, J, F, 4),
              (B, J, J, F, 2 * Rmax * Rmax), (B, F)]
    got = [torch.full(s, float("nan")) for s in shapes]
    mask = sum(1 << j for j, r in enumerate(ranks) if r == 2)
    err = getattr(lib, f"pyfasst_estep_j{J}")(
        *(t.data_ptr() for t in (x4, v, A4, sigma, *got)), B, F, N, mask,
        Rmax, int(real), int(ns), ctypes.c_float(1e-30),
        int(flag == "fast_recip"), int(flag == "no_ll"), None)
    assert err == 0
    want = cuda_estep.estep_ref(x4, v, A4, sigma, ranks, ns_inj=ns,
                                real_cov=real, no_ll=flag == "no_ll")
    for name, g, w, bar in zip(("xi", "txs", "tss", "t4", "t7"), got, want,
                               (3e-4 if Rmax == 2 else 2e-4,) + (5e-4,) * 4):
        assert bool(torch.isfinite(g).all()), name     # every word written
        assert _rel(g, w) <= bar, name
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)
    for g, w in zip(got[1:5], want[1:5]):              # padding and zeros
        assert torch.equal(g[w == 0], w[w == 0])


# (B, J, F, N, K). N = 1, 31, 33 and 17: tw_stats' strips of 16 frames and
# fb_stats' stages of 128, ragged; F = 3 and 13: fewer rows than tw_stats'
# 16 half-warps, and fb_stats' 8-row tiles ragged; F = 65, 70: less than a
# batch of 128 rows; F = 130 and 258: one and two whole batches and a
# ragged one; K = 16 and 32 at KMAX, K = 5 and 12 below it; F = 530 at
# K = 32: two rows more than tw_stats' chunk of 528 rows, so FB is staged
# twice
SPECTRAL = [(1, 2, 3, 1, 8), (1, 2, 13, 31, 5), (2, 1, 13, 33, 8),
            (1, 2, 70, 45, 16), (1, 1, 65, 17, 32), (1, 2, 130, 200, 8),
            (1, 1, 64, 16, 12), (1, 1, 258, 9, 8), (1, 1, 530, 5, 32),
            # K past 32, the tiled kernel (blocks of 16 output rows: F for
            # fb_stats, N for tw_stats; tiles of 64 positions of the other
            # axis): K = 33, 40 (KPT 5), 48 (6), 56 (7), 63 and 64 (8) in
            # registers; 65 and 100 two chunks of 64, 130 three (past the
            # register budget: totals in the output); one row or one
            # position past a block or a tile (16, 17, 64, 65, 129),
            # N = 1, F = 3; splits of the contracted axis wherever a launch
            # has fewer than 528 blocks: most of these, 1056 x 300 unevenly
            # (fb_stats 3 segments of 2, 2, 1 tiles; tw_stats 9)
            (1, 2, 13, 33, 33), (2, 1, 17, 70, 64), (1, 1, 3, 1, 40),
            (1, 2, 13, 31, 100), (1, 2, 16, 64, 40), (1, 1, 17, 65, 63),
            (2, 1, 33, 129, 64), (1, 2, 65, 17, 65), (1, 1, 15, 200, 100),
            (1, 1, 70, 15, 130), (1, 2, 3, 1, 33), (1, 2, 1056, 300, 40),
            (2, 1, 100, 127, 48), (1, 1, 50, 90, 56), (1, 2, 129, 1, 64)]


def _spectral_case(B, J, F, N, K):
    rng = np.random.default_rng(F * N + K)
    FB = 0.5 + rng.random((B, J, F, K))
    TW = 0.5 + rng.random((B, J, K, N))
    V = np.einsum("bjfk,bjkn->bjfn", FB, TW)
    xi = V * (0.1 + rng.exponential(size=V.shape))
    vfloor = np.quantile(V, 0.3, axis=(2, 3))          # the clamp acts
    vfloor[0, 0] = 1e-30         # and a floor whose square underflows
    return [_t(a) for a in (xi, FB, TW, vfloor)]


def _spectral_run(lib, kernel, inp, K):
    """One launch through the C entry point, with the scratch it asks for;
    (num, den), NaN wherever it wrote nothing."""
    B, J, F, N = inp[0].shape
    shape = (B, J, F, K) if kernel == "fb_stats" else (B, J, K, N)
    got = [torch.full(shape, float("nan")) for _ in range(2)]
    words = getattr(lib, f"pyfasst_{kernel}_workspace")(B, J, F, N, K)
    assert words >= 0
    ws = torch.full((words,), float("nan")) if words else None
    err = getattr(lib, f"pyfasst_{kernel}")(
        *(t.data_ptr() for t in (*inp, *got)),
        None if ws is None else ws.data_ptr(), B, J, F, N, K, None)
    assert err == 0
    return got


@pytest.mark.parametrize("B,J,F,N,K", SPECTRAL)
@pytest.mark.parametrize("kernel", ["fb_stats", "tw_stats"])
def test_spectral_source_matches_plain_version(lib, kernel, B, J, F, N, K):
    inp = _spectral_case(B, J, F, N, K)
    got = _spectral_run(lib, kernel, inp, K)
    want = getattr(cuda_spectral, f"{kernel}_ref")(*inp)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=0)
    if K > 32:                   # the tiled kernel: fixed orders, no atomics
        for g, a in zip(got, _spectral_run(lib, kernel, inp, K)):
            assert torch.equal(g, a)


# The split's threshold: a launch of 528 blocks (16-row blocks x B J) takes
# the contracted axis whole; one of 526 splits it in two, its two segments'
# sums added by the second pass from scratch. fb_stats' rows are F,
# tw_stats' N; the other axis is 65 positions, two tiles.
@pytest.mark.parametrize("rows,split", [(4224, 1), (4208, 2)])
@pytest.mark.parametrize("kernel", ["fb_stats", "tw_stats"])
def test_spectral_split_threshold_at_b1(lib, kernel, rows, split):
    B, J, K = 1, 2, 40
    F, N = (rows, 65) if kernel == "fb_stats" else (65, rows)
    words = getattr(lib, f"pyfasst_{kernel}_workspace")(B, J, F, N, K)
    assert words == (0 if split == 1 else split * 2 * B * J * rows * K)
    inp = _spectral_case(B, J, F, N, K)
    got = _spectral_run(lib, kernel, inp, K)
    want = getattr(cuda_spectral, f"{kernel}_ref")(*inp)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=0)


def test_info_entry_points_answer(lib):
    out = (ctypes.c_int * 4)()
    assert lib.pyfasst_estep_r1_real_info(2, out) == 0
    assert lib.pyfasst_estep_r1_real_info(3, out) == 0
    assert lib.pyfasst_estep_r1_real_info(4, out) != 0
    for K in (8, 16, 32):
        assert lib.pyfasst_tw_stats_info(K, 513, out) == 0
        assert out[3] >= 513 * K * 4           # FB whole in shared memory
        assert lib.pyfasst_fb_stats_info(K, out) == 0
    for K in (33, 40, 48, 56, 64, 65, 100, 1000):    # the tiled kernel
        # Ct in two buffers of min(8 ceil(K / 8), 64) x 68 words, beside
        # xi, q and d: shared memory does not grow past K = 64
        kch = min(-(-K // 8) * 8, 64)
        assert lib.pyfasst_tw_stats_info(K, 513, out) == 0
        assert out[3] >= 2 * kch * 68 * 4 + 3 * 16 * 68 * 4
        assert out[3] <= 56 * 1024
        assert lib.pyfasst_fb_stats_info(K, out) == 0
    assert lib.pyfasst_fb_stats_workspace(0, 2, 9, 9, 40) == -1
    assert lib.pyfasst_tw_stats_info(8, 0, out) != 0
    assert lib.pyfasst_fb_stats_info(0, out) != 0
    for J in cuda_estep.GENERAL_J:
        for rmax in (1, 2):
            fn = getattr(lib, f"pyfasst_estep_j{J}_info")
            assert fn(rmax, 0, 1, out) == 0
        assert fn(3, 0, 0, out) != 0
