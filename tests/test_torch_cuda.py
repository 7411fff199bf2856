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
                                  "fast_recip", "fuse_spectral", "J5",
                                  "J17"])
def test_variants_without_a_kernel_raise_on_cuda(dev, case):
    """Conv mixing, ann_ns_inj and J = 5 sources run through the general
    kernel, J = 17 sources through csrc/estep_many.cu, fast_recip through
    variant e and fuse_spectral through the spectral kernels; float64,
    which no kernel computes, raises, naming its ROADMAP entry."""
    rng = np.random.default_rng(2)
    dtype = torch.float64 if case == "float64" else torch.float32
    tree = _tree(rng, 9, 20, mix="conv" if case == "conv" else "inst")
    if case in ("J5", "J17"):
        J = int(case[1:])
        tree["spat"] = (tree["spat"] * 9)[:J]
        tree["spec"] = [dict(tree["spec"][0], spat_ind=j) for j in range(J)]
    params = convert.params_from_numpy(tree, device=dev, dtype=dtype)
    X = _X(rng, 9, 20, dev)
    if case == "float64":
        X = X.to(torch.complex128)
    cfg = GEMConfig(niter=3,
                    annealing="ann_ns_inj" if case == "ann_ns_inj" else "ann",
                    fast_recip=case == "fast_recip",
                    fuse_spectral=case == "fuse_spectral")
    if case in ("conv", "ann_ns_inj", "fast_recip", "fuse_spectral", "J5",
                "J17"):
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
    # five to eight sources (csrc/estep_j{5..8}.cu)
    "real_r1_J5": (5, (1,) * 5, True, False),
    "c_rank2_J5": (5, (2,) * 5, False, False),
    "c_mixed_J5": (5, (1, 2, 2, 1, 2), False, False),
    "d_ns_inj_r1_J5": (5, (1,) * 5, False, True),
    "c_rank2_real_ns_J6": (6, (2,) * 6, True, True),
    "b_complex_r1_J7": (7, (1,) * 7, False, False),
    "c_rank2_J8": (8, (2,) * 8, False, False),
    "d_ns_inj_r2_J8": (8, (2,) * 8, False, True),
    # nine to sixteen sources (csrc/estep_j{9..16}.cu)
    "d_ns_inj_r1_J9": (9, (1,) * 9, False, True),
    "real_r1_J10": (10, (1,) * 10, True, False),
    "c_rank2_J12": (12, (2,) * 12, False, False),
    "b_complex_r1_J16": (16, (1,) * 16, False, False),
    "c_rank2_J16": (16, (2,) * 16, False, False),
}


# (1, 13, 31), (2, 13, 33) cross the REG kernel's 32-frame tiles (J = 2,
# 3 at rank 1); (1, 513, 189) is the conv paths' own shape, whose last
# tile of the FRAMES kernel (128 frames, every other instantiation) holds
# 61 frames; (1, 7, 128), (2, 5, 129) and (1, 3, 257) end on, one past and
# two tiles and one past its tile
@pytest.mark.parametrize("B,F,N", [(2, 33, 70), (1, 9, 2500), (2, 65, 300),
                                   (1, 13, 31), (2, 13, 33), (1, 513, 189),
                                   (1, 7, 128), (2, 5, 129), (1, 3, 257)])
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


# csrc/estep_many.cu, J at run time: one source, J = 17 (three leave-one-out
# runs, the last of one source), 24 (three whole runs), 32 and 48; every
# variant among the cases; one frame, ragged quads and 32-frame tiles,
# B = 2; (1, 513, 500) at J = 17 rank 2 splits each row's 16 tiles into 3
# segments of the fused route (the second pass adds their partials). The
# chunked route past the fused route's last J (MANY_FUSED_LAST, by rank
# and mixing): J = 32 and 48 at complex rank 2, and at (1, 513, 500) J =
# 49 complex rank 2 and J = 94 real rank 1, whose features outgrow one
# chunk (256 MiB a clip): 4 and 3 chunks. xi equals the plain version's
# bits (no fast_recip), two launches give the same bits.
MANY_FUSED_LAST = {(1, True): 60, (1, False): 51, (2, True): 37,
                   (2, False): 30}
MANY = [(1, (1,), True, False, "", 1, 5, 33),
        (17, (1,) * 17, True, False, "", 1, 33, 70),
        (17, (2,) * 17, False, False, "", 2, 9, 45),
        (17, (1, 2) * 8 + (1,), False, True, "no_ll", 1, 7, 1),
        (17, (2,) * 17, False, False, "", 1, 513, 500),
        (24, (1,) * 24, False, False, "fast_recip", 1, 13, 65),
        (24, (2,) * 24, True, True, "", 1, 5, 37),
        (32, (1,) * 32, True, False, "", 2, 9, 129),
        (32, (2,) * 32, False, True, "fast_recip", 1, 5, 31),
        (48, (1,) * 48, False, False, "", 1, 5, 33),
        (48, (2, 1) * 24, False, False, "no_ll", 1, 3, 40),
        (49, (2,) * 49, False, False, "", 1, 513, 500),
        (94, (1,) * 94, True, False, "", 1, 513, 500)]


@pytest.mark.parametrize("J,ranks,real,ns,flag,B,F,N", MANY)
def test_many_kernel_matches_plain_version(dev, J, ranks, real, ns, flag, B,
                                           F, N):
    plan = cuda_estep.many_plan(B, J, F, N, max(ranks), real)
    if J <= MANY_FUSED_LAST[max(ranks), real]:
        assert plan["route"] == "fused"
        assert plan["segments"] == (3 if N == 500 else 1)
    else:
        assert plan["route"] == "chunked"
        assert plan["segments"] == (-(-N // plan["frames"]))
        assert plan["segments"] == ({49: 4, 94: 3}[J] if N == 500 else 1)
    inp = _general_inputs(B, J, F, N, ranks, real, B * F * N + J, dev)
    kw = dict(ns_inj=ns, real_cov=real)
    fl = {flag: True} if flag else {}
    launches = dict(cuda_estep.VARIANT_LAUNCHES)
    got = cuda_estep.estep_general(*inp, ranks, **kw, **fl)
    want = cuda_estep.estep_ref(*inp, ranks, **kw, no_ll=flag == "no_ll")
    torch.cuda.synchronize()
    key = "b" if not real else "a"
    key = "c" if max(ranks) == 2 else key
    key = "d" if ns else key
    assert cuda_estep.VARIANT_LAUNCHES[key] == launches[key] + 1
    xi_bar = 3e-4 if max(ranks) == 2 else 2e-4
    for g, w, rtol in zip(got[:5], want[:5], (xi_bar,) + (5e-4,) * 4):
        # (one source has no T7: an all-zero output, equal word for word)
        assert g.shape == w.shape and (torch.equal(g, w)
                                       or _rel(g, w) <= rtol)
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)
    if flag != "fast_recip":
        assert torch.equal(got[0], want[0])
    again = cuda_estep.estep_general(*inp, ranks, **kw, **fl)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# The general kernel past eight sources (csrc/estep_j{9..16}.cu): its WIDE
# kernel where wide_lanes takes it (one lane a frame over 128-frame tiles,
# or two lanes over 64-frame tiles at rank 2 from J = 13 complex and at J =
# 16 real, the second lane one source short at odd J), FRAMES elsewhere.
# One frame; 63, 64, 65, 127, 128, 129 and 192 frames (across both tile
# sizes); 70 and 100 (a last tile of 6 and 36 frames); every J of 9-16
# with every variant among the cases, B = 2; and the path's plane (1, 513,
# 863). xi equals the plain version's bits (no fast_recip), two launches
# give the same bits.
WIDE = [(9, (1,) * 9, True, False, "", 1, 33, 63),
        (9, (2, 1) * 4 + (2,), False, True, "fast_recip", 2, 9, 127),
        (10, (1,) * 10, True, False, "", 1, 513, 863),
        (10, (1,) * 10, False, False, "no_ll", 1, 17, 65),
        (11, (2,) * 11, True, False, "", 1, 9, 64),
        (11, (1,) * 11, False, True, "", 2, 5, 1),
        (12, (2,) * 12, False, False, "", 1, 13, 129),
        (12, (1, 2) * 6, False, False, "fast_recip", 1, 9, 70),
        (13, (1,) * 13, True, False, "", 1, 9, 100),
        (13, (2,) * 13, False, True, "no_ll", 1, 5, 128),
        (14, (1,) * 14, False, False, "", 1, 17, 192),
        (14, (2,) * 14, True, True, "", 1, 5, 65),
        (15, (2,) * 15, False, False, "", 2, 5, 63),
        (15, (1,) * 15, True, False, "no_ll", 1, 33, 129),
        (16, (2,) * 16, False, False, "", 1, 9, 64),
        (16, (1,) * 16, True, False, "", 2, 5, 100),
        (16, (2, 1) * 8, False, True, "", 1, 9, 70)]


@pytest.mark.parametrize("J,ranks,real,ns,flag,B,F,N", WIDE)
def test_wide_kernel_matches_plain_version(dev, J, ranks, real, ns, flag, B,
                                           F, N):
    inp = _general_inputs(B, J, F, N, ranks, real, B * F * N + J, dev)
    kw = dict(ns_inj=ns, real_cov=real)
    fl = {flag: True} if flag else {}
    launches = cuda_estep.LAUNCHES
    got = cuda_estep.estep_general(*inp, ranks, **kw, **fl)
    want = cuda_estep.estep_ref(*inp, ranks, **kw, no_ll=flag == "no_ll")
    torch.cuda.synchronize()
    assert cuda_estep.LAUNCHES == launches + 1
    xi_bar = 3e-4 if max(ranks) == 2 else 2e-4
    for g, w, rtol in zip(got[:5], want[:5], (xi_bar,) + (5e-4,) * 4):
        assert g.shape == w.shape and _rel(g, w) <= rtol
    torch.testing.assert_close(got[5].sum(-1), want[5].sum(-1), rtol=1e-4,
                               atol=0)
    if flag != "fast_recip":
        assert torch.equal(got[0], want[0])
    again = cuda_estep.estep_general(*inp, ranks, **kw, **fl)
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
    (2, 1, 64, 7, 32), (1, 2, 530, 45, 32), (1, 2, 513, 863, 16),
    # K above 32: the tiled kernel (16-row blocks, 64-position tiles),
    # at the bench shape and the host API's B = 1 (split contracted axis);
    # KPT 5 to 8 (K = 40, 48, 56, 64) in registers, chunks of 64 past it
    # (100: two, 130: three); ragged blocks and tiles, uneven splits
    (8, 2, 513, 863, 40), (8, 2, 513, 863, 64), (1, 2, 33, 70, 40),
    (2, 1, 13, 33, 64), (1, 2, 21, 31, 100), (1, 2, 513, 863, 40),
    (1, 2, 513, 863, 64), (1, 2, 70, 129, 48), (2, 1, 33, 200, 56),
    (1, 2, 100, 300, 100), (1, 1, 65, 17, 130), (1, 2, 1056, 300, 40)])
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
    ("tw_stats", (32, 513), 8), ("fb_stats", (8,), 32),
    # the tiled kernel past K = 32: four blocks of four warps, 128 registers
    ("fb_stats", (40,), 16), ("fb_stats", (64,), 16), ("fb_stats", (100,), 16),
    ("tw_stats", (40, 513), 16), ("tw_stats", (64, 513), 16),
    ("tw_stats", (100, 513), 16)])
def test_kernel_info_reports_the_resident_warps_aimed_at(dev, name, args,
                                                         warps):
    """The occupancy each source's __launch_bounds__ aims at, as the runtime
    reports it, with at most a few words of spill."""
    from pyfasst_tpu_torch.ops import _build
    info = _build.kernel_info(name, *args)
    assert info["warps_per_sm"] >= warps
    assert 0 < info["registers"] <= 255
    assert info["local_bytes"] <= 16
    if name == "tw_stats" and args[0] <= 32:   # FB whole in shared memory
        assert info["shared_bytes"] >= args[0] * args[1] * 4


@pytest.mark.parametrize("J", [5, 6, 7, 8])
def test_general_kernel_keeps_its_sums_in_registers(dev, J):
    """Every instantiation of the general kernel at J = 5 to 8 runs without
    spill (runtime local bytes 0), at 12 or more resident warps per SM (8
    with ns_inj at rank 2, which takes 255 registers)."""
    from pyfasst_tpu_torch.ops import _build
    for rmax in (1, 2):
        for real in (0, 1):
            for ns in (0, 1):
                info = _build.kernel_info(f"estep_j{J}", rmax, real, ns)
                assert info["local_bytes"] == 0, (rmax, real, ns)
                assert info["warps_per_sm"] >= (8 if ns and rmax == 2
                                                else 12), (rmax, real, ns)


def test_spectral_wrappers_check_their_inputs(dev):
    xi, FB, TW, vfloor = _spectral_inputs(1, 2, 9, 20, 3, 0, dev)
    for fn in (cuda_spectral.fb_stats, cuda_spectral.tw_stats):
        with pytest.raises(ValueError, match="shape"):
            fn(xi, FB, TW[..., :10].contiguous(), vfloor)
        with pytest.raises(TypeError, match="float32"):
            fn(xi.double(), FB, TW, vfloor)
        with pytest.raises(ValueError, match="on cpu"):
            fn(xi, FB, TW, vfloor.cpu())
    # a rank past 32 launches the tiled kernel
    inp = _spectral_inputs(1, 2, 9, 20, 33, 0, dev)
    for name in ("fb_stats", "tw_stats"):
        for g, w in zip(getattr(cuda_spectral, name)(*inp),
                        getattr(cuda_spectral, f"{name}_ref")(*inp)):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=0)


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
    """K = 40, past one chunk of 32 components, with fuse_spectral: both
    spectral kernels launch once per iteration (their wide form), and the
    run stays within rounding of the unfused one (loglik rtol 1e-4, the
    factors within 1e-3 of their peak)."""
    rng = np.random.default_rng(6)
    params = convert.params_from_numpy(_tree(rng, 17, 30, K=40), device=dev)
    X = _X(rng, 17, 30, dev)
    spectral = dict(cuda_spectral.LAUNCHES)
    p_f, ll_f = gem.run_gem(params, X, GEMConfig(niter=3,
                                                 fuse_spectral=True))
    assert cuda_spectral.LAUNCHES == {k: n + 3 for k, n in spectral.items()}
    p_u, ll_u = gem.run_gem(params, X, GEMConfig(niter=3))
    torch.testing.assert_close(ll_f, ll_u, rtol=1e-4, atol=0)
    for a, b in zip(p_f.spec, p_u.spec):
        for x, y in ((a.TW, b.TW), (a.FB, b.FB)):
            assert float((x - y).abs().max()) <= 1e-3 * float(y.abs().max())


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


# -- streaming (ops/online.py, models/streaming.py) ---------------------------

_STREAM_CASES = {"rank1_I2": (2, False), "rank1_I3": (3, False),
                 "fullrank_I2": (2, True)}


def _stream_problem(case, seed, F=33, K=3, Nb=64, nb=3):
    """X (1, F, nb * Nb, I), A0, FB0, TW0, sigma as CPU tensors (B = 1)."""
    I, full = _STREAM_CASES[case]
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((1, F, nb * Nb, I))
         + 1j * rng.standard_normal((1, F, nb * Nb, I)))
    shape = (1, 2, F, I, I) if full else (1, 2, F, I)
    A0 = (0.4 + rng.random(shape)) * (1.0 + 0.2j * rng.random(shape))
    if full:
        A0[..., 1] *= 0.2
    FB0 = 0.5 + rng.random((1, 2, F, K))
    TW0 = 0.5 + rng.random((1, 2, K, Nb))
    sigma = 0.01 + 0.005 * rng.random((1, F))
    c64, f32 = torch.complex64, torch.float32
    return (torch.as_tensor(X, dtype=c64), torch.as_tensor(A0, dtype=c64),
            torch.as_tensor(FB0, dtype=f32), torch.as_tensor(TW0, dtype=f32),
            torch.as_tensor(sigma, dtype=f32), nb)


@pytest.mark.parametrize("case", sorted(_STREAM_CASES))
def test_online_blocks_on_cuda_match_cpu(dev, case):
    """Three online blocks on the card against the CPU: every state field
    but t7 (float32 rounding in both packages, tests/test_torch_online.py)
    within 1e-3 of its peak, TW too, loglik rtol 1e-4. Rank-1 stereo blocks
    launch variant b 7 times each (6 inner iterations and the final
    E-step); the full-rank and I = 3 blocks launch nothing."""
    from pyfasst_tpu_torch.ops import online
    X, A0, FB0, TW0, sigma, nb = _stream_problem(case, seed=31)
    Nb = TW0.shape[-1]
    runs = {}
    for d in ("cpu", dev):
        state = online.online_init(A0.to(d), FB0.to(d))
        before = dict(cuda_estep.VARIANT_LAUNCHES)
        lls, tws = [], []
        for b in range(nb):
            state, (TWb, ll) = online.online_block(
                state, X[:, :, b * Nb:(b + 1) * Nb].to(d), TW0.to(d),
                sigma.to(d), forgetting=0.95, inner_iters=6)
            lls.append(ll)
            tws.append(TWb)
        counts = {k: cuda_estep.VARIANT_LAUNCHES[k] - before[k]
                  for k in before}
        runs[str(d)] = (state, torch.cat(tws, -1), torch.cat(lls), counts)
    (cs, ctw, cll, ccounts), (gs, gtw, gll, gcounts) = runs["cpu"], \
        runs[str(dev)]
    assert not any(ccounts.values())
    want_b = 7 * nb if case == "rank1_I2" else 0
    assert gcounts == dict(ccounts, b=want_b)
    assert gs.A.device.type == "cuda"
    for name in online.OnlineState._fields:
        if name == "t7":
            continue
        g, c = getattr(gs, name).cpu(), getattr(cs, name)
        peak = float(c.abs().max())
        assert float((g - c).abs().max()) <= 1e-3 * peak + 1e-30, name
    assert float((gtw.cpu() - ctw).abs().max()) <= 1e-3 * float(
        ctw.abs().max())
    np.testing.assert_allclose(gll.cpu().numpy(), cll.numpy(), rtol=1e-4)


def test_online_block_without_a_kernel_raises_on_cuda(dev):
    """J = 5 stereo blocks: the general kernel computes the E-step at five
    sources (variant b, 7 launches: 6 inner iterations and the final
    E-step), and the block lies within rounding of its CPU run (every
    state field but t7 within 1e-3 of its peak, TW too, loglik rtol
    1e-4)."""
    from pyfasst_tpu_torch.ops import online
    rng = np.random.default_rng(3)
    F, K, Nb = 9, 2, 8
    A0 = torch.as_tensor(0.4 + rng.random((1, 5, F, 2)),
                         dtype=torch.complex64)
    FB0 = torch.as_tensor(0.5 + rng.random((1, 5, F, K)),
                          dtype=torch.float32)
    TW0 = torch.as_tensor(0.5 + rng.random((1, 5, K, Nb)),
                          dtype=torch.float32)
    X = torch.as_tensor(rng.standard_normal((1, F, Nb, 2)),
                        dtype=torch.complex64)
    runs = {}
    for d in ("cpu", dev):
        before = cuda_estep.VARIANT_LAUNCHES["b"]
        state, (TWb, ll) = online.online_block(
            online.online_init(A0.to(d), FB0.to(d)), X.to(d), TW0.to(d),
            torch.full((1, F), 0.01, device=d), forgetting=0.95,
            inner_iters=6)
        runs[str(d)] = (state, TWb, ll,
                        cuda_estep.VARIANT_LAUNCHES["b"] - before)
    (cs, ctw, cll, cb), (gs, gtw, gll, gb) = runs["cpu"], runs[str(dev)]
    assert cb == 0 and gb == 7
    for name in online.OnlineState._fields:
        if name == "t7":
            continue
        g, c = getattr(gs, name).cpu(), getattr(cs, name)
        assert float((g - c).abs().max()) <= 1e-3 * float(c.abs().max()) \
            + 1e-30, name
    assert float((gtw.cpu() - ctw).abs().max()) <= 1e-3 * float(
        ctw.abs().max())
    np.testing.assert_allclose(gll.cpu().numpy(), cll.numpy(), rtol=1e-4)


def _stream_wav(path, seconds=4.0, channels=2, seed=7):
    from scipy.signal import butter, lfilter
    from pyfasst_tpu_torch.audio import wavwrite
    rng = np.random.default_rng(seed)
    n = int(8000 * seconds)
    srcs = []
    for lo, hi in ((0.02, 0.3), (0.25, 0.8)):
        b, a = butter(4, [lo, hi], btype="band")
        s = lfilter(b, a, rng.standard_normal(n))
        srcs.append(s / np.std(s))
    pans = np.array([[0.95, 0.31], [0.31, 0.95]])[:, :channels]
    mix = sum(np.outer(s, p) for s, p in zip(srcs, pans))
    wavwrite(mix / (1.05 * np.max(np.abs(mix))), 8000, path)
    return path


@pytest.mark.parametrize("rank", [1, -1])
def test_separate_streaming_on_cuda_matches_cpu(dev, tmp_path, rank):
    """separate_streaming on the card against the CPU (4 s at 8 kHz, wlen
    512, blocks of 32 frames): logliks rtol 1e-4, images within 1e-3 of
    their peak; rank 1 launches variant b 7 times per block step of both
    passes, full rank nothing."""
    from pyfasst_tpu_torch import separate_streaming
    path = _stream_wav(str(tmp_path / "s.wav"))
    kw = dict(J=2, K=4, wlen=512, frames_per_block=32, verbose=0,
              spatial_rank=rank)
    y_cpu, i_cpu = separate_streaming(path, device="cpu", **kw)
    before = cuda_estep.VARIANT_LAUNCHES["b"]
    total = cuda_estep.LAUNCHES
    y_gpu, i_gpu = separate_streaming(path, device=dev, **kw)
    steps = i_gpu["blocks"] + 4          # 126 frames: 4 blocks in pass 2
    want = 7 * steps if rank == 1 else 0
    assert cuda_estep.VARIANT_LAUNCHES["b"] - before == want
    assert cuda_estep.LAUNCHES - total == want
    np.testing.assert_allclose(i_gpu["logliks"], i_cpu["logliks"],
                               rtol=1e-4)
    assert y_gpu.shape == y_cpu.shape == (2, 32000, 2)
    assert np.max(np.abs(y_gpu - y_cpu)) < 1e-3 * np.max(np.abs(y_cpu))


def test_separate_streaming_resume_on_cuda_is_bit_exact(dev, tmp_path):
    from pyfasst_tpu_torch import separate_streaming
    path = _stream_wav(str(tmp_path / "s.wav"))
    kw = dict(J=2, K=4, wlen=512, frames_per_block=16, verbose=0,
              device=dev)
    y_ref, i_ref = separate_streaming(path, **kw)
    ck = str(tmp_path / "ck.npz")
    separate_streaming(path, checkpoint_path=ck, checkpoint_every=2,
                       estimate_blocks=4, **kw)
    y, info = separate_streaming(path, checkpoint_path=ck, **kw)
    assert info["resumed_at"] == 4 and info["blocks"] == i_ref["blocks"]
    assert info["logliks"] == i_ref["logliks"]
    assert np.array_equal(y, y_ref)


def test_stream_blocks_and_synthesis_on_cuda(dev, tmp_path):
    """Blocks read on the card equal the card's whole transform bit for
    bit and the CPU's within 2e-6 of the peak; the card's streaming
    synthesis inverts them within 1e-5 of the signal's peak."""
    from pyfasst_tpu_torch.audio import wav_read
    from pyfasst_tpu_torch.tf.stft import STFT
    path = _stream_wav(str(tmp_path / "s.wav"), seconds=2.0)
    data = wav_read(path)[0].astype(np.float32)
    gpu = STFT(wlen=512, fs=8000, device=dev)
    blocks = list(gpu.stream_blocks(path, 16))
    assert blocks[0].device.type == "cuda"
    whole = gpu.computeTransform(data)
    assert torch.equal(torch.cat(blocks, dim=1), whole)
    cpu = STFT(wlen=512, fs=8000, device="cpu").computeTransform(data)
    assert float((whole.cpu() - cpu).abs().max()) < 2e-6 * float(
        cpu.abs().max())
    syn = gpu.synthesis_stream(data.shape[0])
    y = np.concatenate([syn.push(b) for b in blocks] + [syn.flush()])
    assert y.shape == data.shape
    assert np.max(np.abs(y - data)) < 1e-5 * np.max(np.abs(data))


def test_blind_mono_on_cuda_matches_cpu(dev):
    """estim_param_blind_mono on the card (general engine, no launch)
    against the CPU run from the same model and the same spectra: the
    CPU model takes the card's Xs, since the init's 50 float64 IS-NMF
    iterations carry the two FFTs' rounding (~1e-7) to ~1e-4 of the first
    loglik (ROADMAP.md §3, the mono prefix seed)."""
    mix = _mix3(np.random.default_rng(2), channels=1)
    kw = dict(fs=16000, nbComps=2, nbNMFComps=3, wlen=256, iter_num=10)
    cpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device="cpu", **kw)
    gpu = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device=dev, **kw)
    cpu.Xs = gpu.Xs.cpu()
    gpu.params = convert.params_from_numpy(
        convert.params_to_numpy(cpu.params), device=dev)
    launches = cuda_estep.LAUNCHES
    ll_gpu = gpu.estim_param_blind_mono(nmf_iters=50)
    ll_cpu = cpu.estim_param_blind_mono(nmf_iters=50)
    assert cuda_estep.LAUNCHES == launches
    np.testing.assert_allclose(ll_gpu, ll_cpu, rtol=1e-4)
    y_gpu, y_cpu = gpu.separated_images(), cpu.separated_images()
    assert np.max(np.abs(y_gpu - y_cpu)) < 1e-3 * np.max(np.abs(y_cpu))


# -- the blind reverberant pipeline (models/spatial_init, binfeat, reverb) ---

def _blind_plane(F=65, N=96, seed=0):
    """Two spectrally and spatially distinct sources, per-frequency mixing
    wobble (tests/test_reverb_pipeline.py::_reverb_mixture's recipe):
    (F, N, 2) complex128."""
    rng = np.random.default_rng(seed)
    a = np.array([[1.0, 0.3], [0.25, 1.0]], complex)
    wob = np.exp(1j * 0.5 * np.sin(np.arange(F) / 5.0))
    A = np.stack([np.stack([a[j, 0] * np.ones(F), a[j, 1] * wob ** (j + 1)],
                           -1) for j in range(2)])
    on = (np.arange(N) // 12) % 2 == 0
    gain = np.stack([np.where(on, 1.0, 0.05), np.where(on, 0.05, 1.0)])
    band = np.stack([np.exp(-((np.arange(F) - 18) / 12.0) ** 2),
                     np.exp(-((np.arange(F) - 44) / 12.0) ** 2)]) + 0.05
    s = (rng.standard_normal((2, F, N)) + 1j * rng.standard_normal(
        (2, F, N))) * gain[:, None, :] * band[:, :, None]
    return np.einsum('jfi,jfn->fni', A, s)


def test_device_kmeans_on_cuda_matches_cpu(dev):
    from pyfasst_tpu_torch.models import spatial_init as si
    X = _blind_plane(seed=1)
    feat, w, pw, _ = si.tf_covariance_features(X)
    lab_gpu = si._cluster_labels_device(feat, w, 2, 4, 10, device=dev)
    lab_cpu = si._cluster_labels_device(feat, w, 2, 4, 10, device="cpu")
    assert (lab_gpu == lab_cpu).mean() > 0.99
    for align in ("spectral", "activity"):
        v_gpu = si.consensus_votes(X, 2, n_seeds=3, kiter=10, align=align,
                                   device=dev)
        v_cpu = si.consensus_votes(X, 2, n_seeds=3, kiter=10, align=align,
                                   device="cpu")
        assert (v_gpu.argmax(-1) == v_cpu.argmax(-1)).mean() > 0.99


def test_lanczos_embedding_on_cuda_matches_cpu(dev):
    """_lanczos_top to sign, and the device alignment path undoing planted
    permutations over 3075 nodes (above the host path's cutoff)."""
    from pyfasst_tpu_torch.models import spatial_init as si
    rng = np.random.default_rng(0)
    A = rng.standard_normal((300, 300)).astype(np.float32)
    M = torch.as_tensor(A @ A.T / 300)
    U_gpu = si._lanczos_top(M.to(dev), 3).cpu().numpy()
    U_cpu = si._lanczos_top(M, 3).numpy()
    for j in range(3):
        assert abs(float(U_gpu[:, j] @ U_cpu[:, j])) > 0.999
    F, J, N = 1025, 3, 64
    base = np.stack([1.0 + 0.9 * np.sin(2 * np.pi * np.arange(N) / p)
                     for p in (7.0, 13.0, 29.0)])
    perms = np.stack([rng.permutation(J) for _ in range(F)])
    act = base[perms] * rng.uniform(0.5, 2.0, (F, 1, 1))
    act += 0.05 * rng.uniform(size=act.shape)
    U, npow = si._embed_nodes(act, None, device=dev)
    cent = si._spherical_kmeans(U, npow, J, seed=0)
    sel = si._assignment_from_embedding(U, cent, F, J)
    comp = np.take_along_axis(perms, sel, axis=1)
    assert (comp == comp[0]).all()


def test_binfeat_embed_on_cuda_matches_cpu(dev):
    """The shipped weights' embedding on the card (cuDNN, TF32 off) within
    1e-4 of the CPU's; the learned votes agree on >= 99% of the
    power-weighted bins."""
    from pyfasst_tpu_torch.models import binfeat
    X = _blind_plane(seed=4)
    inp, pw = binfeat.bin_inputs(X)
    params = binfeat.load_params()
    V_gpu = binfeat.embed_host(params, inp, device=dev)
    V_cpu = binfeat.embed_host(params, inp, device="cpu")
    assert np.max(np.abs(V_gpu - V_cpu)) < 1e-4
    l_gpu = binfeat.learned_votes(X, 2, params, device=dev).argmax(-1)
    l_cpu = binfeat.learned_votes(X, 2, params, device="cpu").argmax(-1)
    assert ((l_gpu == l_cpu) * pw).sum() / pw.sum() >= 0.99


def test_pool_statistics_on_cuda_match_cpu(dev):
    """The pool's blind statistics of a chunk of separations: envelope
    correlation, band coherence and shares within 1e-5, the judge's
    confusion and the seed agreement within 1e-5 relative."""
    from pyfasst_tpu_torch.models import reverb
    rng = np.random.default_rng(5)
    Y = (rng.standard_normal((3, 2, 40, 30, 2))
         + 1j * rng.standard_normal((3, 2, 40, 30, 2))) \
        * rng.random((3, 2, 40, 1, 1))
    Y = torch.as_tensor(Y, dtype=torch.complex64)
    jv = torch.as_tensor(np.eye(2)[rng.integers(0, 2, (40, 30))],
                         dtype=torch.float32)
    pw = torch.as_tensor(rng.random((40, 30)), dtype=torch.float32)
    got = reverb._chunk_stats(Y.to(dev), pw.to(dev), jv.to(dev), True)
    want = reverb._chunk_stats(Y, pw, jv, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_blind_pool_on_cuda_launches_variant_c(dev):
    """The pool at chunk = 4 on the card: every GEM iteration one launch
    of variant c (rank 2), each 4 runs wide, then one per iteration of the
    reseed stage (B = 1); the same pick and stage history as the CPU run
    of the port, finite images within 1e-3 of its peak."""
    from pyfasst_tpu_torch.models import reverb
    X = _blind_plane()
    kw = dict(iters=20, em_seeds=1, reseed_rounds=1, nmf_comps=3, chunk=4,
              n_seeds=3)
    widths = []
    kernel = cuda_estep.estep_general

    def spy(x4, *args, **kwargs):
        widths.append(int(x4.shape[0]))
        return kernel(x4, *args, **kwargs)

    before = dict(cuda_estep.VARIANT_LAUNCHES)
    cuda_estep.estep_general = spy
    try:
        Y_gpu, info = reverb.blind_reverb_separate(X, J=2, device=dev, **kw)
    finally:
        cuda_estep.estep_general = kernel
    c = cuda_estep.VARIANT_LAUNCHES["c"] - before["c"]
    runs = info["history"][0]["pool"]
    chunks = -(-runs // 4)
    stages = len(info["history"]) - 1
    assert c == len(widths) == 20 * (chunks + stages)
    assert widths == [min(4, runs)] * (20 * chunks) + [1] * (20 * stages)
    Y_cpu, info_cpu = reverb.blind_reverb_separate(X, J=2, device="cpu", **kw)
    assert [h["picked"] for h in info["history"]] == \
        [h["picked"] for h in info_cpu["history"]]
    assert np.all(np.isfinite(Y_gpu.view(np.float32)))
    assert np.abs(Y_gpu - Y_cpu).max() < 1e-3 * np.abs(Y_cpu).max()


# -- the CLI on the card -----------------------------------------------------

def _cli_wav(tmp_path, seconds=1.0, fs=8000, seed=0):
    """tests/test_cli.py's fixture: a 440 Hz tone and noise, panned, PCM16."""
    from pyfasst_tpu_torch.audio import wavwrite
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    s1 = 0.5 * np.sin(2 * np.pi * 440 * t)
    s2 = 0.3 * rng.standard_normal(n)
    mix = np.stack([0.9 * s1 + 0.3 * s2, 0.3 * s1 + 0.9 * s2], 1)
    p = str(tmp_path / "mix.wav")
    wavwrite(mix, fs, p)
    return p


def _cli(argv, capsys):
    import json

    from pyfasst_tpu_torch.__main__ import main
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["inst", "fullrank"])
def test_cli_default_device_is_the_card(dev, tmp_path, capsys, model):
    """`separate` without --device runs on the card: one E-step launch per
    iteration; its loglik and images agree with the --device cpu run
    within the card-vs-CPU bars (loglik rtol 1e-4, images 1e-3 of the
    peak)."""
    from pyfasst_tpu_torch.audio import wavread
    wav = _cli_wav(tmp_path)
    argv = ["separate", wav, "--iters", "10", "--nmf-comps", "3", "--wlen",
            "256", "--model", model, "-q"]
    before = cuda_estep.LAUNCHES
    gpu = _cli(argv + ["-o", str(tmp_path / "gpu")], capsys)
    launched = cuda_estep.LAUNCHES - before
    cpu = _cli(argv + ["-o", str(tmp_path / "cpu"), "--device", "cpu"],
               capsys)
    assert launched == 10
    np.testing.assert_allclose(gpu["final_loglik"], cpu["final_loglik"],
                               rtol=1e-4)
    for a, b in zip(gpu["files"], cpu["files"]):
        ya, yb = wavread(a)[0], wavread(b)[0]
        assert np.abs(ya - yb).max() <= 1e-3 * np.abs(yb).max() + 1 / 32768


def test_cli_info_and_demix_on_the_card(dev, tmp_path, capsys):
    """info and demix (host NumPy in both packages) on the card's machine:
    the header's five fields, and DEMIX's two directions."""
    wav = _cli_wav(tmp_path)
    assert _cli(["info", wav], capsys) == {
        "samplerate": 8000, "channels": 2, "frames": 8000, "bits": 16,
        "format": "pcm"}
    rep = _cli(["demix", wav, "--wlen", "256", "--sources", "2"], capsys)
    assert rep["sources"] == 2 and len(rep["delays_samples"]) == 2


def test_cli_resume_round_trip_on_the_card(dev, tmp_path, capsys):
    """--checkpoint on the card, then --resume with the same --iters: zero
    iterations (final_loglik null), the same WAVs bit for bit; the card's
    checkpoint resumed on the CPU writes them within 1e-3 of the peak."""
    from pyfasst_tpu_torch.audio import wavread
    wav = _cli_wav(tmp_path)
    ck = str(tmp_path / "ck.npz")
    base = ["separate", wav, "--iters", "8", "--nmf-comps", "3", "--wlen",
            "256", "-q"]
    full = _cli(base + ["-o", str(tmp_path / "a"), "--checkpoint", ck,
                        "--checkpoint-every", "4"], capsys)
    again = _cli(base + ["-o", str(tmp_path / "b"), "--resume", ck], capsys)
    on_cpu = _cli(base + ["-o", str(tmp_path / "c"), "--resume", ck,
                          "--device", "cpu"], capsys)
    assert np.isfinite(full["final_loglik"])
    assert again["final_loglik"] is None and on_cpu["final_loglik"] is None
    for a, b, c in zip(full["files"], again["files"], on_cpu["files"]):
        ya, yb, yc = (wavread(p)[0] for p in (a, b, c))
        assert np.array_equal(ya, yb)
        assert np.abs(yc - ya).max() <= 1e-3 * np.abs(ya).max() + 1 / 32768


def test_speech_preset_with_the_jax_draws_gives_the_jax_rows(dev, tmp_path):
    """`separate --preset speech` on the card at full width (chip_smoke.py
    phase 17's run) with the JAX package's EM-seed draws (jax.random on
    the host, as tests/test_torch_spatial_init.py::jax_draws makes them)
    in place of the port's: the JAX package's TPU rows for fixture seeds
    120 and 122 (docs/validation.md:37: 9.46 and 6.84 dB) within 0.05 dB.
    With the port's own draws seed 120 lands on 4.40 dB, on the card and
    the CPU alike (chip_smoke.CPU_SDR_SPEECH): the gap is the draw. Needs
    jax beside torch; imports nothing of the JAX package."""
    import importlib.util
    import os
    from pathlib import Path

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from pyfasst_tpu_torch.models import spatial_init as tsi
    from pyfasst_tpu_torch.models.components import SpectralComp
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def draws(seed, J, F, N, K, dtype=torch.float32, device="cpu"):
        out = []
        for j, key in enumerate(jax.random.split(jax.random.PRNGKey(seed),
                                                 J)):
            k1, k2 = jax.random.split(key)
            FB = 0.5 + jax.random.uniform(k1, (F, K), jnp.float32)
            TW = 0.5 + jax.random.uniform(k2, (K, N), jnp.float32)
            out.append(SpectralComp(
                FB=torch.tensor(np.asarray(FB), dtype=dtype,
                                device=device)[None],
                TW=torch.tensor(np.asarray(TW), dtype=dtype,
                                device=device)[None], spat_ind=j))
        return tuple(out)

    orig = tsi._em_seed_spec
    tsi._em_seed_spec = draws
    try:
        for seed, want in ((120, 9.46), (122, 6.84)):
            mix, ys_true = cs.speech_fixture(**dict(cs.SPEECH, seed=seed))
            r = cs.blind_cli(str(tmp_path), "speech", mix, ys_true,
                             cs.SPEECH["fs"], name=f"speech{seed}")
            assert abs(r["min_sdr"] - want) <= 0.05, (seed, r["min_sdr"])
    finally:
        tsi._em_seed_spec = orig


def test_speech_preset_gives_the_jax_rows_with_its_own_draws(dev, tmp_path):
    """The port's own EM-seed draws are the JAX package's (utils/prng.py),
    so the speech preset on fixture seeds 120 and 122 lands on the JAX
    package's TPU rows with no draws injected (the test above)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for seed, want in ((120, 9.46), (122, 6.84)):
        mix, ys_true = cs.speech_fixture(**dict(cs.SPEECH, seed=seed))
        r = cs.blind_cli(str(tmp_path), "speech", mix, ys_true,
                         cs.SPEECH["fs"], name=f"speech{seed}")
        assert abs(r["min_sdr"] - want) <= 0.05, (seed, r["min_sdr"])


def _mesh_problem(dev):
    from pyfasst_tpu_torch.parallel import dryrun
    prob = dryrun.tiny_problem(B=4, F=65, N=40)
    cfg = GEMConfig(niter=8)
    X = torch.as_tensor(prob["X"], device=dev)
    sig = gem.annealing_endpoints(X, cfg)
    params, ll = gem.run_gem(dryrun.tiny_params(prob, device=dev), X, cfg,
                             sigma_endpoints=sig)
    return prob, cfg, params, ll


def test_world_size_one_on_nccl_is_bit_for_bit(dev, tmp_path):
    """A process group of one rank on NCCL: batched_run_gem and
    sharded_batch_separate on make_mesh(1) give run_gem's and
    separate_sources' bits on the card."""
    import torch.distributed as dist

    from pyfasst_tpu_torch.ops.wiener import separate_sources
    from pyfasst_tpu_torch.parallel import dryrun, sharding
    prob, cfg, params, ll = _mesh_problem(dev)
    X = torch.as_tensor(prob["X"], device=dev)
    Y = separate_sources(params, X, gem.annealing_endpoints(X, cfg)[1])
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(device=dev)
        assert mesh.size == 1
        out, ll1 = sharding.batched_run_gem(
            dryrun.tiny_params(prob, device=dev), X, cfg, mesh)
        Y1 = sharding.sharded_batch_separate(
            out, X, gem.annealing_endpoints(X, cfg)[1], mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(ll1, ll) and torch.equal(Y1, Y)
    for k, v in dryrun._host(out).items():
        np.testing.assert_array_equal(v, dryrun._host(params)[k])


def test_fp2_on_gloo_with_both_ranks_on_one_card(dev):
    """Two gloo ranks on cuda:0 (parallel/dryrun.py): the fp, dp and sp
    legs, and fp with the fused spectral kernels, against the single-card
    run at rtol 2e-4; every rank launches the E-step kernel once per
    iteration on its slice (and the spectral kernels when fused), from
    the host or in a replay of run_gem's CUDA graph (the dp leg)."""
    from pyfasst_tpu_torch.parallel import dryrun
    prob, cfg, params, ll = _mesh_problem(dev)
    want = dryrun._host(params)
    fused = dataclasses.replace(cfg, fuse_spectral=True)
    cases = [("legs", "sharding_cases",
              dict(prob=prob, niter=cfg.niter, device="cuda:0")),
             ("fused", "run_sharded",
              dict(params_b=dryrun.tiny_params(prob), X_b=prob["X"],
                   cfg=fused, device="cuda:0", separate=None))]
    for rank in dryrun.spawn(dryrun.run_cases, 2, cases):
        runs = dict(rank["legs"], fused=rank["fused"])
        for leg, got in runs.items():
            np.testing.assert_allclose(got["logliks"], ll.cpu().numpy(),
                                       rtol=dryrun.RTOL, err_msg=leg)
            for k, v in got["params"].items():
                np.testing.assert_allclose(
                    v, want[k], rtol=dryrun.RTOL,
                    atol=dryrun.RTOL * np.abs(want[k]).max(), err_msg=leg)
            n = got["launches"]["replayed"]      # run_gem's graph replays
            assert got["launches"]["estep"] + n == cfg.niter, (leg, got)
        n = runs["fused"]["launches"]["replayed"]
        assert runs["fused"]["launches"]["fb_stats"] + n == cfg.niter
        assert runs["fused"]["launches"]["tw_stats"] + n == cfg.niter
