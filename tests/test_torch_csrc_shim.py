"""The CUDA sources of the port, compiled for the CPU and run at ragged shapes.

csrc/estep.cu and csrc/spectral.cu are compiled with g++ against the
stand-in headers of tests/cuda_shim/ (threads, barriers and shuffles on
std::thread; one block at a time), from a scratch copy in which

    kernel<<<grid, block, smem, stream>>>(args);   ->  shim::launch(...)
    extern __shared__ ... float name[];            ->  shim::dynamic_shared()
    recip.cuh's rcp.approx asm                     ->  1 / x

and estep_r1_real, tw_stats and fb_stats are held against their plain
PyTorch versions at shapes that cross every tile edge of the kernels (one
frame, 31 and 33 frames, fewer rows than a batch, two rows more than a
chunk, K below and at KMAX). Built with -ffp-contract=off, as nvcc builds
with --fmad=false. It is a check of indexing, masking, barriers and the
order of the sums, not of the card: the kernels' agreement on the card is
held by tests/test_torch_cuda.py and chip_smoke.py. Skips where g++ or
-std=c++20 (std::barrier) is missing.

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
SOURCES = ("estep.cu", "spectral.cu")
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
    for src in (*SOURCES, "recip.cuh"):
        (tmp / src).write_text(translate((CSRC / src).read_text()))
    out = tmp / "libshim.so"
    cmd = [gxx, *flags, "-shared", "-x", "c++", "-I", str(tmp), "-I",
           str(ROOT / "cuda_shim"), *(str(tmp / s) for s in SOURCES), "-o",
           str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.pyfasst_estep_r1_real.argtypes = [p] * 10 + [i] * 4 + [f] + [i] * 2 + [p]
    for name in ("pyfasst_fb_stats", "pyfasst_tw_stats"):
        getattr(so, name).argtypes = [p] * 6 + [i] * 5 + [p]
    so.pyfasst_estep_r1_real_info.argtypes = [i, p]
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


# (B, J, F, N, K). N = 1, 31, 33 and 17: tw_stats' strips of 16 frames and
# fb_stats' stages of 128, ragged; F = 3 and 13: fewer rows than tw_stats'
# 16 half-warps, and fb_stats' 8-row tiles ragged; F = 65, 70: less than a
# batch of 128 rows; F = 130 and 258: one and two whole batches and a
# ragged one; K = 16 and 32 at KMAX, K = 5 and 12 below it; F = 530 at
# K = 32: two rows more than tw_stats' chunk of 528 rows, so FB is staged
# twice
SPECTRAL = [(1, 2, 3, 1, 8), (1, 2, 13, 31, 5), (2, 1, 13, 33, 8),
            (1, 2, 70, 45, 16), (1, 1, 65, 17, 32), (1, 2, 130, 200, 8),
            (1, 1, 64, 16, 12), (1, 1, 258, 9, 8), (1, 1, 530, 5, 32)]


@pytest.mark.parametrize("B,J,F,N,K", SPECTRAL)
@pytest.mark.parametrize("kernel", ["fb_stats", "tw_stats"])
def test_spectral_source_matches_plain_version(lib, kernel, B, J, F, N, K):
    rng = np.random.default_rng(F * N + K)
    FB = 0.5 + rng.random((B, J, F, K))
    TW = 0.5 + rng.random((B, J, K, N))
    V = np.einsum("bjfk,bjkn->bjfn", FB, TW)
    xi = V * (0.1 + rng.exponential(size=V.shape))
    vfloor = np.quantile(V, 0.3, axis=(2, 3))          # the clamp acts
    vfloor[0, 0] = 1e-30         # and a floor whose square underflows
    inp = [_t(a) for a in (xi, FB, TW, vfloor)]
    shape = (B, J, F, K) if kernel == "fb_stats" else (B, J, K, N)
    got = [torch.full(shape, float("nan")) for _ in range(2)]
    err = getattr(lib, f"pyfasst_{kernel}")(
        *(t.data_ptr() for t in (*inp, *got)), B, J, F, N, K, None)
    assert err == 0
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
    assert lib.pyfasst_tw_stats_info(33, 513, out) != 0
    assert lib.pyfasst_tw_stats_info(8, 0, out) != 0
