"""The CUDA E-step kernel and the port's CUDA dispatch, on an NVIDIA GPU.

Every test here needs a card (marker `cuda`) and skips without one; the
file imports nothing of the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py -q

Bars: the kernel against its plain version at the bars of
tests/test_pallas_estep.py (xi 2e-4, frame reductions 5e-4, loglik 1e-4;
relative, with a floor of 1e-3 of each output's largest entry, for exact
zeros). CUDA runs against CPU runs of the port: loglik rtol 1e-4 and
images within 1e-3 of their peak after 10 float32 iterations -- the
kernel's rank-1 posterior form 1/(1 + v M) and the CPU path's
(2 + v t)/(1 + v t) - 1 agree only to rounding, and cuBLAS sums in its own
order.
"""
import numpy as np
import pytest
import torch

import pyfasst_tpu_torch
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.ops import cuda_estep, gem
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


@pytest.mark.parametrize("B,J,F,N", [(2, 2, 33, 70), (1, 2, 9, 2500),
                                     (2, 3, 17, 40), (8, 2, 513, 863)])
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
                                  "fast_recip", "fuse_spectral"])
def test_variants_without_a_kernel_raise_on_cuda(dev, case):
    rng = np.random.default_rng(2)
    dtype = torch.float64 if case == "float64" else torch.float32
    params = convert.params_from_numpy(
        _tree(rng, 9, 20, mix="conv" if case == "conv" else "inst"),
        device=dev, dtype=dtype)
    X = _X(rng, 9, 20, dev)
    if case == "float64":
        X = X.to(torch.complex128)
    cfg = GEMConfig(niter=3,
                    annealing="ann_ns_inj" if case == "ann_ns_inj" else "ann",
                    fast_recip=case == "fast_recip",
                    fuse_spectral=case == "fuse_spectral")
    with pytest.raises(NotImplementedError):
        gem.run_gem(params, X, cfg)


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
