"""The CUDA kernels and the port's CUDA dispatch, on an NVIDIA GPU.

Every test here needs a card (marker `cuda`) and skips without one; the
file imports nothing of the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py -q

Bars: the kernel against its plain version at the bars of
tests/test_pallas_estep.py (xi 2e-4, frame reductions 5e-4, loglik 1e-4;
relative, with a floor of 1e-3 of each output's largest entry, for exact
zeros; xi 3e-4 for rank 2). CUDA runs against CPU runs of the port:
loglik rtol 1e-4 and images within 1e-3 of their peak after 10 float32
iterations -- the kernels' posterior forms (1/(1 + v M) for rank 1, the
clamped closed-form G^-1 for rank 2) and the CPU path's agree only to
rounding, and cuBLAS sums in its own order. The spectral kernels
(fb_stats, tw_stats) against their plain versions: rtol 2e-5, the bar of
tests/test_pallas_spectral.py (sums of positive terms in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import pyfasst_tpu_torch
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral, gem
from pyfasst_tpu_torch.utils.config import GEMConfig

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _tree(rng, F, N, mix="inst", K=3):
    spat = []
    for _ in range(2):
        if mix == "inst":
            spat.append({"A": np.abs(rng.standard_normal((2, 1))) + 0.3,
                         "mix_type": "inst"})
        else:
            spat.append({"A": (rng.standard_normal((F, 2, 1))
                               + 1j * rng.standard_normal((F, 2, 1))) * 0.5,
                         "mix_type": "conv"})
    spec = [{"FB": 0.5 + rng.random((F, K)), "TW": 0.5 + rng.random((K, N)),
             "spat_ind": j} for j in range(2)]
    return {"spat": spat, "spec": spec}


def _X(rng, F, N, device):
    X = rng.standard_normal((1, F, N, 2)) + 1j * rng.standard_normal(
        (1, F, N, 2))
    return torch.as_tensor(X, dtype=torch.complex64, device=device)


def _rel(got, want):
    floor = 1e-3 * float(want.abs().max())
    return float(((got - want).abs() / (want.abs() + floor)).max())


# the next six cross the kernel's tiles of 32 frames: N = 1, 31, 33 and 7;
# the last is the ERBlet plane's few long rows (F = 48), its N ragged
@pytest.mark.parametrize("B,J,F,N", [(2, 2, 33, 70), (1, 2, 9, 2500),
                                     (2, 3, 17, 40), (8, 2, 513, 863),
                                     (2, 2, 5, 1), (1, 2, 13, 31),
                                     (2, 2, 13, 33), (1, 2, 3, 7),
                                     (1, 3, 13, 31), (2, 3, 9, 33),
                                     (1, 2, 48, 98299)])
def test_kernel_matches_plain_version(dev, B, J, F, N):
    rng = np.random.default_rng(B * F * N)
    x4 = torch.as_tensor(rng.standard_normal((B, 4, F, N)),
                         dtype=torch.float32, device=dev)
    v = torch.as_tensor(0.5 + 4 * rng.random((B, J, F, N)),
                        dtype=torch.float32, device=dev)
    A = torch.as_tensor(0.3 + rng.random((B, J, 1, 2)), dtype=torch.float32,
                        device=dev).expand(B, J, F, 2).contiguous()
    sigma = torch.as_tensor(0.01 + 0.005 * rng.random((B, F)),
                            dtype=torch.float32, device=dev)
    launches = cuda_estep.LAUNCHES
    got = cuda_estep.estep_r1_real(x4, v, A, sigma)
    want = cuda_estep.estep_r1_real_ref(x4, v, A, sigma)
    torch.cuda.synchronize()
    assert cuda_estep.LAUNCHES == launches + 1
    for g, w, rtol in zip(got[:5], want[:5], (2e-4,) + (5e-4,) * 4):
        assert g.shape == w.shape and _rel(g, w) <= rtol
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)
    # xi has no sum in it: the plain version's bits; and the words written
    # from a mirrored sum or as a constant are the plain version's too
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2][..., 0], got[2][..., 0].transpose(1, 2))
    assert torch.equal(got[2][..., 1], -got[2][..., 1].transpose(1, 2))
    for g, w in zip(got[2:5], want[2:5]):
        assert torch.equal(g[w == 0], w[w == 0])
    # deterministic: no atomics, fixed reduction order
    again = cuda_estep.estep_r1_real(x4, v, A, sigma)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_kernel_wrapper_checks_its_inputs(dev):
    x4 = torch.zeros((1, 4, 5, 7), device=dev)
    v = torch.ones((1, 2, 5, 7), device=dev)
    A = torch.ones((1, 2, 5, 2), device=dev)
    sigma = torch.ones((1, 5), device=dev)
    with pytest.raises(TypeError, match="float32"):
        cuda_estep.estep_r1_real(x4, v.double(), A, sigma)
    with pytest.raises(ValueError, match="shape"):
        cuda_estep.estep_r1_real(x4, v, A[:, :, :4], sigma)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_estep.estep_r1_real(x4, v, A.transpose(2, 3).contiguous()
                                 .transpose(2, 3), sigma)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_estep.estep_r1_real(x4, v, A, sigma.cpu())


def test_gem_step_on_cuda_goes_through_the_kernel(dev, monkeypatch):
    """A CUDA tensor never reaches the plain E-step inside gem_step."""
    def forbidden(*a, **k):
        raise AssertionError("CPU E-step called with CUDA tensors")
    monkeypatch.setattr(gem, "compute_suff_stats", forbidden)
    rng = np.random.default_rng(1)
    params = convert.params_from_numpy(_tree(rng, 17, 30), device=dev)
    X = _X(rng, 17, 30, dev)
    sigma = torch.full((1, 17), 0.01, device=dev)
    launches = cuda_estep.LAUNCHES
    _, ll = gem.gem_step(params, X, sigma, GEMConfig(niter=3))
    assert cuda_estep.LAUNCHES == launches + 1
    assert bool(torch.isfinite(ll).all())


@pytest.mark.parametrize("case", ["conv", "float64", "ann_ns_inj",
                                  "fast_recip", "fuse_spectral", "J5"])
def test_variants_without_a_kernel_raise_on_cuda(dev, case):
    """Conv mixing and ann_ns_inj run through the general kernel, fast_recip
    through variant e and fuse_spectral through the spectral kernels; the
    variants still to port (float64, J = 5) raise, naming their ROADMAP
    entry."""
    rng = np.random.default_rng(2)
    dtype = torch.float64 if case == "float64" else torch.float32
    tree = _tree(rng, 9, 20, mix="conv" if case == "conv" else "inst")
    if case == "J5":
        tree["spat"] = (tree["spat"] * 3)[:5]
        tree["spec"] = [dict(tree["spec"][0], spat_ind=j) for j in range(5)]
    params = convert.params_from_numpy(tree, device=dev, dtype=dtype)
    X = _X(rng, 9, 20, dev)
    if case == "float64":
        X = X.to(torch.complex128)
    cfg = GEMConfig(niter=3,
                    annealing="ann_ns_inj" if case == "ann_ns_inj" else "ann",
                    fast_recip=case == "fast_recip",
                    fuse_spectral=case == "fuse_spectral")
    if case in ("conv", "ann_ns_inj", "fast_recip", "fuse_spectral"):
        launches = cuda_estep.LAUNCHES
        e_launches = cuda_estep.VARIANT_LAUNCHES["e"]
        spectral = dict(cuda_spectral.LAUNCHES)
        _, ll = gem.run_gem(params, X, cfg)
        assert cuda_estep.LAUNCHES == launches + 3
        assert cuda_estep.VARIANT_LAUNCHES["e"] == e_launches + (
            3 if case == "fast_recip" else 0)
        fused = 3 if case == "fuse_spectral" else 0
        assert cuda_spectral.LAUNCHES == {k: n + fused
                                          for k, n in spectral.items()}
        assert bool(torch.isfinite(ll).all())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gem.run_gem(params, X, cfg)


def _general_inputs(B, J, F, N, ranks, real, seed, device):
    rng = np.random.default_rng(seed)
    Rmax = max(ranks)
    A4 = np.zeros((B, J, F, 4 * Rmax))
    for j, R in enumerate(ranks):
        a = rng.standard_normal((B, F, 4 * R)) * 0.7
        if real:
            a[..., 1::2] = 0.0
        A4[:, j, :, :4 * R] = a
    arrays = (rng.standard_normal((B, 4, F, N)),
              0.5 + 4 * rng.random((B, J, F, N)), A4,
              0.01 + 0.005 * rng.random((B, F)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            .contiguous() for a in arrays]


# name: (J, ranks, real_cov, ns_inj)
GENERAL = {
    "b_complex_r1_J3": (3, (1, 1, 1), False, False),
    "c_rank2_J4": (4, (2, 2, 2, 2), False, False),
    "c_mixed_J4": (4, (1, 2, 2, 1), False, False),
    "d_ns_inj_r1_J3": (3, (1, 1, 1), False, True),
    "d_ns_inj_r2_J4": (4, (2, 2, 2, 2), False, True),
    "real_rank2_ns_J2": (2, (2, 1), True, True),
    "real_r1_J4": (4, (1, 1, 1, 1), True, False),
}


# the last three cross the kernel's 32-frame tiles (N = 31, 33) and take
# the conv paths' own shape (B = 1, F = 513, N = 189)
@pytest.mark.parametrize("B,F,N", [(2, 33, 70), (1, 9, 2500), (2, 65, 300),
                                   (1, 13, 31), (2, 13, 33), (1, 513, 189)])
@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_kernel_matches_plain_version(dev, name, B, F, N):
    J, ranks, real, ns = GENERAL[name]
    inp = _general_inputs(B, J, F, N, ranks, real, B * F * N + J, dev)
    launches = cuda_estep.LAUNCHES
    got = cuda_estep.estep_general(*inp, ranks, ns_inj=ns, real_cov=real)
    want = cuda_estep.estep_ref(*inp, ranks, ns_inj=ns, real_cov=real)
    torch.cuda.synchronize()
    assert cuda_estep.LAUNCHES == launches + 1
    xi_bar = 3e-4 if max(ranks) == 2 else 2e-4
    for g, w, rtol in zip(got[:5], want[:5], (xi_bar,) + (5e-4,) * 4):
        assert g.shape == w.shape and _rel(g, w) <= rtol
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)
    again = cuda_estep.estep_general(*inp, ranks, ns_inj=ns, real_cov=real)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_general_kernel_wrapper_checks_its_inputs(dev):
    x4, v, A4, sigma = _general_inputs(1, 2, 5, 7, (2, 1), False, 0, dev)
    with pytest.raises(ValueError, match="shape"):
        cuda_estep.estep_general(x4, v, A4[..., :4].contiguous(), sigma,
                                 (2, 1))
    with pytest.raises(TypeError, match="float32"):
        cuda_estep.estep_general(x4, v.double(), A4, sigma, (2, 1))
    with pytest.raises(ValueError, match="on cpu"):
        cuda_estep.estep_general(x4, v, A4, sigma.cpu(), (2, 1))
    with pytest.raises(NotImplementedError, match="ranks 1 and 2"):
        cuda_estep.estep_general(x4, v, torch.zeros((1, 2, 5, 12),
                                                    device=dev), sigma,
                                 (3, 1))


@pytest.mark.parametrize("rank,ns", [(1, False), (2, False), (2, True)])
def test_conv_gem_step_on_cuda_goes_through_the_kernel(dev, monkeypatch,
                                                       rank, ns):
    """Conv and full-rank E-steps on CUDA never reach the plain E-step."""
    def forbidden(*a, **k):
        raise AssertionError("CPU E-step called with CUDA tensors")
    monkeypatch.setattr(gem, "compute_suff_stats", forbidden)
    rng = np.random.default_rng(rank)
    tree = _tree(rng, 17, 30, mix="conv")
    for c in tree["spat"]:
        c["A"] = np.repeat(c["A"], rank, axis=-1) + 0.1 * rank * (
            rng.standard_normal((17, 2, rank)))
    params = convert.params_from_numpy(tree, device=dev)
    X = _X(rng, 17, 30, dev)
    launches = dict(cuda_estep.VARIANT_LAUNCHES)
    cfg = GEMConfig(niter=3, annealing="ann_ns_inj" if ns else "ann")
    _, ll = gem.run_gem(params, X, cfg)
    assert bool(torch.isfinite(ll).all())
    now = cuda_estep.VARIANT_LAUNCHES
    assert now["b"] == launches["b"] + 3
    assert now["c"] == launches["c"] + (3 if rank == 2 else 0)
    assert now["d"] == launches["d"] + (3 if ns else 0)


def _conv_mixture(rng, J, n=8000):
    """J of three delayed sources (a tone, gated noise, lowpass noise)."""
    t = np.arange(n) / 16000
    srcs = [np.sin(2 * np.pi * 440 * t),
            rng.standard_normal(n) * (np.sin(2 * np.pi * 3 * t) > 0),
            np.convolve(rng.standard_normal(n), np.ones(6) / 6, "same")]
    return 0.3 * sum(np.stack([s, g * np.roll(s, d)], 1) for s, g, d in
                     list(zip(srcs, [0.5, 1.0, 1.6], [-3, 0, 2]))[:J])


@pytest.mark.parametrize("rank", [1, 2])
def test_conv_model_on_cuda_matches_cpu(dev, rank):
    """Rank 1 (ERB basis) on a determined two-source mixture, rank 2 on an
    underdetermined three-source one. (Rank 1 with three sources in two
    channels is ill-conditioned at the end of a 10-iteration schedule: two
    float32 CPU runs of it, XLA-form and kernel-form E-step, lie 1.2-2.3e-3
    of the peak apart, and each ~1.5e-3 from a float64 run.)"""
    J = 2 if rank == 1 else 3
    mix = _conv_mixture(np.random.default_rng(rank), J)
    kw = dict(fs=16000, nbComps=J, nbNMFComps=4, wlen=256, iter_num=10,
              spatial_rank=rank, freq_basis="erb" if rank == 1 else None,
              n_bands=16)
    cpu = pyfasst_tpu_torch.MultiChanNMFConv(mix, device="cpu", **kw)
    gpu = pyfasst_tpu_torch.MultiChanNMFConv(mix, device=dev, **kw)
    gpu.params = convert.params_from_numpy(
        convert.params_to_numpy(cpu.params), device=dev)
    launches = cuda_estep.LAUNCHES
    ll_gpu = gpu.estim_param_a_posteriori()
    assert cuda_estep.LAUNCHES == launches + 10
    ll_cpu = cpu.estim_param_a_posteriori()
    np.testing.assert_allclose(ll_gpu, ll_cpu, rtol=1e-4)
    y_gpu, y_cpu = gpu.separated_images(), cpu.separated_images()
    assert np.max(np.abs(y_gpu - y_cpu)) < 1e-3 * np.max(np.abs(y_cpu))


def test_host_api_on_cuda_matches_cpu(dev):
    rng = np.random.default_rng(3)
    t = np.arange(8000) / 16000
    s1 = np.sin(2 * np.pi * 440 * t)
    s2 = rng.standard_normal(t.size) * (np.sin(2 * np.pi * 3 * t) > 0)
    mix = 0.3 * (np.outer(s1, [0.9, 0.4]) + np.outer(s2, [0.3, 0.9]))
    kw = dict(fs=16000, nbComps=2, nbNMFComps=4, wlen=256, iter_num=10)
    cpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device="cpu", **kw)
    gpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device=dev, **kw)
    gpu.params = convert.params_from_numpy(
        convert.params_to_numpy(cpu.params), device=dev)
    launches = cuda_estep.LAUNCHES
    ll_gpu = gpu.estim_param_a_posteriori()
    assert cuda_estep.LAUNCHES == launches + 10
    ll_cpu = cpu.estim_param_a_posteriori()
    np.testing.assert_allclose(ll_gpu, ll_cpu, rtol=1e-4)
    y_gpu, y_cpu = gpu.separated_images(), cpu.separated_images()
    assert np.max(np.abs(y_gpu - y_cpu)) < 1e-3 * np.max(np.abs(y_cpu))


# -- variants e (fast_recip) and f (no_ll) --------------------------------------

@pytest.mark.parametrize("B,J,F,N", [(2, 2, 33, 70), (8, 2, 513, 863),
                                     (1, 3, 9, 2500), (1, 3, 13, 31),
                                     (2, 3, 9, 33), (2, 3, 5, 1),
                                     (1, 2, 13, 31)])
@pytest.mark.parametrize("flag", ["fast_recip", "no_ll"])
def test_kernel_variants_e_f_match_plain_version(dev, flag, B, J, F, N):
    rng = np.random.default_rng(B * F * N + J)
    x4 = torch.as_tensor(rng.standard_normal((B, 4, F, N)),
                         dtype=torch.float32, device=dev)
    v = torch.as_tensor(0.5 + 4 * rng.random((B, J, F, N)),
                        dtype=torch.float32, device=dev)
    A = torch.as_tensor(0.3 + rng.random((B, J, 1, 2)), dtype=torch.float32,
                        device=dev).expand(B, J, F, 2).contiguous()
    sigma = torch.as_tensor(0.01 + 0.005 * rng.random((B, F)),
                            dtype=torch.float32, device=dev)
    key = "e" if flag == "fast_recip" else "f"
    launches = cuda_estep.VARIANT_LAUNCHES[key]
    got = cuda_estep.estep_r1_real(x4, v, A, sigma, **{flag: True})
    want = cuda_estep.estep_r1_real_ref(x4, v, A, sigma,
                                        no_ll=flag == "no_ll")
    torch.cuda.synchronize()
    assert cuda_estep.VARIANT_LAUNCHES[key] == launches + 1
    for g, w, rtol in zip(got[:5], want[:5], (2e-4,) + (5e-4,) * 4):
        assert _rel(g, w) <= rtol
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)


@pytest.mark.parametrize("flag", ["fast_recip", "no_ll"])
@pytest.mark.parametrize("name", ["b_complex_r1_J3", "c_rank2_J4",
                                  "d_ns_inj_r2_J4", "real_rank2_ns_J2"])
def test_general_kernel_variants_e_f_match_plain_version(dev, name, flag):
    J, ranks, real, ns = GENERAL[name]
    inp = _general_inputs(2, J, 65, 300, ranks, real, 65 * 300 + J, dev)
    key = "e" if flag == "fast_recip" else "f"
    launches = cuda_estep.VARIANT_LAUNCHES[key]
    got = cuda_estep.estep_general(*inp, ranks, ns_inj=ns, real_cov=real,
                                   **{flag: True})
    want = cuda_estep.estep_ref(*inp, ranks, ns_inj=ns, real_cov=real,
                                no_ll=flag == "no_ll")
    torch.cuda.synchronize()
    assert cuda_estep.VARIANT_LAUNCHES[key] == launches + 1
    xi_bar = 3e-4 if max(ranks) == 2 else 2e-4
    for g, w, rtol in zip(got[:5], want[:5], (xi_bar,) + (5e-4,) * 4):
        assert _rel(g, w) <= rtol
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)


# -- the spectral kernels (fb_stats, tw_stats) ----------------------------------

def _spectral_inputs(B, J, F, N, K, seed, device):
    rng = np.random.default_rng(seed)
    FB = 0.5 + rng.random((B, J, F, K))
    TW = 0.5 + rng.random((B, J, K, N))
    V = np.einsum("bjfk,bjkn->bjfn", FB, TW)
    xi = V * (0.1 + rng.exponential(size=V.shape))
    vfloor = np.quantile(V, 0.3, axis=(2, 3))      # the clamp acts
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            .contiguous() for a in (xi, FB, TW, vfloor)]


# (2, 2, 13, 31, 8) to (1, 2, 513, 189, 8) cross fb_stats' tiles (8 rows,
# 128 frames): F = 13, N in {31, 33, 189}, and the conv paths' shape; the
# last five cross tw_stats' strips of 16 frames (N = 1, 7, 33, 45), its
# batches of 128 rows (F = 3, 64, 129) and its chunk of FB in shared
# memory (F = 530 at K = 32: two chunks)
@pytest.mark.parametrize("B,J,F,N,K", [
    (8, 2, 513, 863, 8), (2, 2, 37, 95, 5), (2, 2, 130, 300, 5),
    (2, 3, 70, 211, 4), (1, 2, 33, 70, 16), (1, 2, 33, 70, 32),
    (2, 2, 13, 31, 8), (1, 3, 13, 33, 16), (1, 2, 21, 189, 32),
    (1, 2, 513, 189, 8), (1, 2, 3, 1, 8), (1, 2, 129, 33, 16),
    (2, 1, 64, 7, 32), (1, 2, 530, 45, 32), (1, 2, 513, 863, 16)])
@pytest.mark.parametrize("kernel", ["fb_stats", "tw_stats"])
def test_spectral_kernel_matches_plain_version(dev, kernel, B, J, F, N, K):
    inp = _spectral_inputs(B, J, F, N, K, B * F * N + K, dev)
    launches = cuda_spectral.LAUNCHES[kernel]
    got = getattr(cuda_spectral, kernel)(*inp)
    want = getattr(cuda_spectral, f"{kernel}_ref")(*inp)
    torch.cuda.synchronize()
    assert cuda_spectral.LAUNCHES[kernel] == launches + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=2e-5, atol=0)
    again = getattr(cuda_spectral, kernel)(*inp)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("name,args,warps", [
    ("estep_r1_real", (2,), 28), ("estep_r1_real", (3,), 16),
    ("tw_stats", (8, 513), 24), ("tw_stats", (16, 513), 16),
    ("tw_stats", (32, 513), 8), ("fb_stats", (8,), 32)])
def test_kernel_info_reports_the_resident_warps_aimed_at(dev, name, args,
                                                         warps):
    """The occupancy each source's __launch_bounds__ aims at, as the runtime
    reports it, with at most a few words of spill."""
    from pyfasst_tpu_torch.ops import _build
    info = _build.kernel_info(name, *args)
    assert info["warps_per_sm"] >= warps
    assert 0 < info["registers"] <= 255
    assert info["local_bytes"] <= 16
    if name == "tw_stats":                 # FB whole in shared memory
        assert info["shared_bytes"] >= args[0] * args[1] * 4


def test_spectral_wrappers_check_their_inputs(dev):
    xi, FB, TW, vfloor = _spectral_inputs(1, 2, 9, 20, 3, 0, dev)
    for fn in (cuda_spectral.fb_stats, cuda_spectral.tw_stats):
        with pytest.raises(ValueError, match="shape"):
            fn(xi, FB, TW[..., :10].contiguous(), vfloor)
        with pytest.raises(TypeError, match="float32"):
            fn(xi.double(), FB, TW, vfloor)
        with pytest.raises(ValueError, match="on cpu"):
            fn(xi, FB, TW, vfloor.cpu())
    xi, FB, TW, vfloor = _spectral_inputs(1, 2, 9, 20, 33, 0, dev)
    with pytest.raises(NotImplementedError, match="K <= 32"):
        cuda_spectral.fb_stats(xi, FB, TW, vfloor)


def test_fused_bench_model_on_cuda_matches_cpu(dev):
    """Ten iterations of the fused path on the card against the unfused
    CPU run of the same model."""
    rng = np.random.default_rng(4)
    t = np.arange(8000) / 16000
    s1 = np.sin(2 * np.pi * 440 * t)
    s2 = rng.standard_normal(t.size) * (np.sin(2 * np.pi * 3 * t) > 0)
    mix = 0.3 * (np.outer(s1, [0.9, 0.4]) + np.outer(s2, [0.3, 0.9]))
    kw = dict(fs=16000, nbComps=2, nbNMFComps=4, wlen=256, iter_num=10)
    cpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device="cpu", **kw)
    gpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device=dev, **kw)
    gpu.cfg = dataclasses.replace(gpu.cfg, fuse_spectral=True)
    gpu.params = convert.params_from_numpy(
        convert.params_to_numpy(cpu.params), device=dev)
    launches = dict(cuda_spectral.LAUNCHES)
    ll_gpu = gpu.estim_param_a_posteriori()
    assert cuda_spectral.LAUNCHES == {k: n + 10 for k, n in launches.items()}
    ll_cpu = cpu.estim_param_a_posteriori()
    np.testing.assert_allclose(ll_gpu, ll_cpu, rtol=1e-4)
    y_gpu, y_cpu = gpu.separated_images(), cpu.separated_images()
    assert np.max(np.abs(y_gpu - y_cpu)) < 1e-3 * np.max(np.abs(y_cpu))


def test_graph_capture_and_replay_launch_counts(dev):
    """A call under CUDA-graph capture records the kernel without launching
    it, and the graph's replays bypass the wrappers: neither counts. The
    replay computes what an eager call computes."""
    rng = np.random.default_rng(7)
    x4 = torch.as_tensor(rng.standard_normal((1, 4, 13, 70)),
                         dtype=torch.float32, device=dev)
    v = torch.as_tensor(0.5 + rng.random((1, 3, 13, 70)),
                        dtype=torch.float32, device=dev)
    A4 = torch.as_tensor(0.7 * rng.standard_normal((1, 3, 13, 4)),
                         dtype=torch.float32, device=dev)
    sigma = torch.full((1, 13), 0.01, dtype=torch.float32, device=dev)
    spec = _spectral_inputs(1, 2, 13, 70, 8, 7, dev)

    def calls():
        return (cuda_estep.estep_general(x4, v, A4, sigma, (1, 1, 1)),
                cuda_spectral.fb_stats(*spec))

    eager = calls()                       # also the warm-up capture asks for
    torch.cuda.synchronize()
    launches = cuda_estep.LAUNCHES
    variants = dict(cuda_estep.VARIANT_LAUNCHES)
    spectral = dict(cuda_spectral.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert cuda_estep.LAUNCHES == launches
    assert cuda_estep.VARIANT_LAUNCHES == variants
    assert cuda_spectral.LAUNCHES == spectral
    for got, want in zip(captured[0] + captured[1], eager[0] + eager[1]):
        assert torch.equal(got, want)
    calls()
    assert cuda_estep.LAUNCHES == launches + 1
    assert cuda_spectral.LAUNCHES["fb_stats"] == spectral["fb_stats"] + 1


# -- checkpoint/resume, batch separation, the general-I engine ------------------

def _mix3(rng, n=8000, channels=3):
    t = np.arange(n) / 16000
    s1 = np.sin(2 * np.pi * 440 * t)
    s2 = rng.standard_normal(n) * (np.sin(2 * np.pi * 3 * t) > 0)
    return 0.3 * (np.outer(s1, [0.9, 0.5, 0.2][:channels])
                  + np.outer(s2, [0.2, 0.6, 0.95][:channels]))


@pytest.mark.parametrize("channels", [3, 1])
def test_general_engine_on_cuda_matches_cpu(dev, channels):
    """I = 3 and mono run on the card in plain PyTorch (no kernel launch)
    and agree with the CPU run at this file's bars."""
    mix = _mix3(np.random.default_rng(channels), channels=channels)
    kw = dict(fs=16000, nbComps=2, nbNMFComps=4, wlen=256, iter_num=10)
    cpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device="cpu", **kw)
    gpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device=dev, **kw)
    gpu.params = convert.params_from_numpy(
        convert.params_to_numpy(cpu.params), device=dev)
    gpu.cfg = dataclasses.replace(gpu.cfg, fuse_spectral=True)
    launches = cuda_estep.LAUNCHES
    spectral = dict(cuda_spectral.LAUNCHES)
    ll_gpu = gpu.estim_param_a_posteriori()
    assert cuda_estep.LAUNCHES == launches
    assert cuda_spectral.LAUNCHES == spectral
    assert gpu.params.spec[0].TW.device.type == "cuda"
    ll_cpu = cpu.estim_param_a_posteriori()
    np.testing.assert_allclose(ll_gpu, ll_cpu, rtol=1e-4)
    y_gpu, y_cpu = gpu.separated_images(), cpu.separated_images()
    assert y_gpu.shape == (2, 8000, channels)
    assert np.max(np.abs(y_gpu - y_cpu)) < 1e-3 * np.max(np.abs(y_cpu))


def test_conv_batch_separate_on_cuda_matches_single_clips(dev):
    """A B = 3 bucket of the conv model against three B = 1 buckets of the
    same clips (one length, no padding): 10 launches of the kernel in each
    run, B = 3 and B = 1 wide."""
    from pyfasst_tpu_torch.parallel.batch import batch_separate
    rng = np.random.default_rng(11)
    F, N = 33, 64
    Xs = [(rng.standard_normal((F, N, 2))
           + 1j * rng.standard_normal((F, N, 2))).astype(np.complex64)
          for _ in range(3)]
    trees = [_tree(np.random.default_rng(20 + i), F, N, mix="conv")
             for i in range(3)]

    def make_params(F_, Npad, i):
        return convert.params_from_numpy(trees[i])

    cfg = GEMConfig(niter=10)
    launches = cuda_estep.LAUNCHES
    imgs, lls = batch_separate(Xs, make_params, cfg, device=dev,
                               granularity=N)
    assert cuda_estep.LAUNCHES == launches + 10
    for i in range(3):
        one, ll1 = batch_separate([Xs[i]], lambda F_, n, _: make_params(
            F_, n, i), cfg, device=dev, granularity=N)
        np.testing.assert_allclose(lls[i], ll1[0], rtol=1e-4)
        assert np.max(np.abs(imgs[i] - one[0])) < 1e-3 * np.max(
            np.abs(one[0]))


def test_host_api_resume_on_cuda_is_bit_exact(dev, tmp_path):
    """A run cut off after its checkpoint at iteration 6 and resumed by a
    new model equals the uninterrupted run bit for bit on the card."""
    mix = _mix3(np.random.default_rng(5), channels=2)
    kw = dict(fs=16000, nbComps=2, nbNMFComps=4, wlen=256, iter_num=12,
              device=dev)
    straight = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, **kw)
    ll_ref = straight.estim_param_a_posteriori()

    class Stopped(Exception):
        pass

    first = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, **kw)
    save = first.save_checkpoint

    def save_then_stop(path, iteration=None):
        save(path, iteration)
        if iteration == 6:
            raise Stopped()

    first.save_checkpoint = save_then_stop
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(Stopped):
        first.estim_param_a_posteriori(checkpoint_path=ck,
                                       checkpoint_every=3)
    resumed = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, **kw)
    assert resumed.load_checkpoint(ck) == 6
    assert resumed.params.spat[0].A.device.type == "cuda"
    ll = resumed.estim_param_a_posteriori(start_iter=6)
    np.testing.assert_array_equal(ll[6:], ll_ref[6:])
    for a, b in zip(convert.params_to_numpy(straight.params)[0]["spec"],
                    convert.params_to_numpy(resumed.params)[0]["spec"]):
        np.testing.assert_array_equal(a["TW"], b["TW"])
        np.testing.assert_array_equal(a["FB"], b["FB"])


def test_fuse_spectral_above_max_k_takes_the_plain_step(dev):
    """K = 40 > MAX_K with fuse_spectral: no spectral kernel launch, and
    the unfused run's numbers bit for bit."""
    rng = np.random.default_rng(6)
    params = convert.params_from_numpy(_tree(rng, 17, 30, K=40), device=dev)
    X = _X(rng, 17, 30, dev)
    spectral = dict(cuda_spectral.LAUNCHES)
    p_f, ll_f = gem.run_gem(params, X, GEMConfig(niter=3,
                                                 fuse_spectral=True))
    assert cuda_spectral.LAUNCHES == spectral
    p_u, ll_u = gem.run_gem(params, X, GEMConfig(niter=3))
    assert torch.equal(ll_f, ll_u)
    for a, b in zip(p_f.spec, p_u.spec):
        assert torch.equal(a.TW, b.TW) and torch.equal(a.FB, b.FB)


# -- front-ends and state models (ROADMAP items 10 and 11) -------------------

def test_erblet_and_minqt_on_cuda_match_cpu(dev):
    """The warped front-ends on the card: analysis and synthesis within
    1e-5 of the CPU runs' peak (cuFFT against pocketfft), and the ERBlet's
    gather synthesis the same bits on every run (no atomics)."""
    from pyfasst_tpu_torch.tf import ERBLetTransform, MinQTransfo
    x = np.random.default_rng(20).standard_normal((24000, 2)).astype(
        np.float32)
    for make in (lambda d: ERBLetTransform(fs=16000, n_bands=48, device=d),
                 lambda d: MinQTransfo(fs=16000, wlen=1024, n_bins=48,
                                       fmin=60, fmax=7000, device=d)):
        cpu, gpu = make("cpu"), make(dev)
        Cc, Cg = cpu.computeTransform(x), gpu.computeTransform(x)
        assert Cg.device.type == "cuda"
        err = float((Cg.cpu() - Cc).abs().max() / Cc.abs().max())
        assert err < 1e-5, err
        yc, yg = cpu.invertTransform(Cc), gpu.invertTransform(Cc.to(dev))
        assert float((yg.cpu() - yc).abs().max() / yc.abs().max()) < 1e-5
        assert torch.equal(gpu.invertTransform(Cc.to(dev)), yg)


def _switch_mix(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(8000) / 8000
    s1 = np.where(np.sin(2 * np.pi * 2 * t) > 0, np.sin(2 * np.pi * 300 * t),
                  np.sin(2 * np.pi * 900 * t))
    s2 = 0.3 * rng.standard_normal(t.size)
    return (np.outer(s1, [0.9, 0.35])
            + np.outer(s2, [0.35, 0.9])).astype(np.float32)


@pytest.mark.parametrize("kind", ["HMM", "GMM", "viterbi", "simm"])
def test_state_models_on_cuda_match_cpu(dev, kind):
    """MultiChanHMM (soft, GMM, viterbi) and the source-filter model on the
    card through kernel 1a, against the CPU run of the same parameters."""
    from pyfasst_tpu_torch import MultiChanHMM, multiChanSourceF0Filter
    mix = _switch_mix(21)
    kw = dict(fs=8000, nbComps=2, iter_num=10, sigma_end_frac=1e-4)
    if kind == "simm":
        def make(d):
            return multiChanSourceF0Filter(mix, nbNMFComps=3, wlen=512,
                                           n_f0=30, f0_min=100, f0_max=600,
                                           n_filter_bands=8, device=d, **kw)
    else:
        def make(d):
            return MultiChanHMM(mix, nbStates=3, wlen=256,
                                sparsity="GMM" if kind == "GMM" else "HMM",
                                decode="viterbi" if kind == "viterbi"
                                else "soft", self_trans=0.95, device=d,
                                **kw)
    cpu, gpu = make("cpu"), make(dev)
    gpu.params = convert.params_from_numpy(
        convert.params_to_numpy(cpu.params), device=dev)
    launches = cuda_estep.VARIANT_LAUNCHES["a"]
    ll_gpu = gpu.estim_param_a_posteriori()
    assert cuda_estep.VARIANT_LAUNCHES["a"] == launches + 10
    ll_cpu = cpu.estim_param_a_posteriori()
    np.testing.assert_allclose(ll_gpu, ll_cpu, rtol=1e-4)
    y_gpu, y_cpu = gpu.separated_images(), cpu.separated_images()
    assert np.max(np.abs(y_gpu - y_cpu)) < 1e-3 * np.max(np.abs(y_cpu))
