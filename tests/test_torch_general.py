"""The port's general-I engine (I != 2 channels) against the JAX package
and the float64 oracle, on the same inputs made with numpy from a seed.

float32 against the JAX package: E-step statistics within 2e-4 (xi) and
5e-4 (frame sums) of each output's peak and loglik rtol 1e-5 (the bars of
tests/test_pallas_estep.py); separations rtol 1e-5 with a floor of 1e-5 of
the peak; 10 GEM iterations at tests/test_torch_gem.py's bars (loglik rtol
1e-5, parameters rtol 1e-4 with a floor of 1e-6 of the peak), on determined
mixtures (J >= I or a full-rank source): with fewer sources than channels
the residual direction of random data carries 1/sigma through a
cancelling projection at the annealed floor, and each package's float32
run lies up to 1% from its float64 run there.
float64 against tests/oracle/fasst_oracle.py: the bars of
tests/test_parity.py (loglik rtol 1e-6; A rtol 1e-5, 1e-4 for the mixed-rank
convolutive case; FB rtol 1e-5; images rtol 5e-5, atol 1e-6). End to end on
the port alone: tests/test_multichannel.py's conservation bar (5e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from pyfasst_tpu.models.components import (
    FasstParams as JParams, SpatialComp as JSpat, SpectralComp as JSpec,
)
from pyfasst_tpu.ops import gem as jgem
from pyfasst_tpu.ops import wiener as jwiener
from pyfasst_tpu.ops.engine_general import suff_stats_general as j_stats
from pyfasst_tpu.ops.mstep import _as_conv_A as j_conv_A
from pyfasst_tpu.utils.config import GEMConfig as JConfig
from pyfasst_tpu_torch.ops import engine_general, gem, wiener
from pyfasst_tpu_torch.ops.mstep import _as_conv_A
from pyfasst_tpu_torch.utils.config import GEMConfig
from tests.oracle import oracle_gem_run, oracle_separate, params_from_pytree
from tests.oracle.fasst_oracle import annealing_endpoints as np_endpoints
from tests.torch_parity import batched, to_torch_params

torch.set_num_threads(1)


def problem(rng, F=19, N=16, K=2, I=3, mix="inst", ranks=(1, 1),
            dtype=np.float32):
    """X (F, N, I) complex numpy, JAX FasstParams, sigma (F,) numpy (the
    fixture of tests/test_parity.py::_tiny_problem_i3, any I and dtype;
    float64 under jax.enable_x64())."""
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    X = (rng.standard_normal((F, N, I))
         + 1j * rng.standard_normal((F, N, I))).astype(cdt)
    X[:, :, 0] *= np.linspace(0.5, 2.0, F)[:, None].astype(dtype)
    spat, spec = [], []
    for j, R in enumerate(ranks):
        if mix == "inst":
            A = (np.abs(rng.standard_normal((I, R))) + 0.3).astype(dtype)
        else:
            A = ((rng.standard_normal((F, I, R))
                  + 1j * rng.standard_normal((F, I, R))) * 0.5).astype(cdt)
        spat.append(JSpat(A=jnp.asarray(A), mix_type=mix))
        spec.append(JSpec(FB=jnp.asarray(0.5 + rng.random((F, K)), dtype),
                          TW=jnp.asarray(0.5 + rng.random((K, N)), dtype),
                          spat_ind=j))
    sigma = (0.01 + 0.005 * rng.random(F)).astype(dtype)
    return X, JParams(spat=tuple(spat), spec=tuple(spec)), sigma


def _peak_close(got, want, frac):
    w = np.asarray(want)
    g = got.detach().numpy()
    assert g.shape == w.shape
    assert np.max(np.abs(g - w)) <= frac * np.max(np.abs(w)), \
        np.max(np.abs(g - w)) / np.max(np.abs(w))


# I, mix, ranks, noise_inject
STATS_CASES = [(3, "inst", (1, 1), False), (3, "inst", (1, 1), True),
               (3, "conv", (1, 3), False), (3, "conv", (2, 1), True),
               (1, "inst", (1, 1), False), (1, "conv", (1, 1), True),
               (4, "conv", (2, 2), False)]


@pytest.mark.parametrize("I,mix,ranks,ns", STATS_CASES)
def test_suff_stats_general_matches_jax(I, mix, ranks, ns):
    rng = np.random.default_rng(I * 10 + sum(ranks) + ns)
    X, jp, sigma = problem(rng, I=I, mix=mix, ranks=ranks)
    F = X.shape[0]
    want = j_stats(jnp.asarray(X), jp.all_source_powers(),
                   tuple(j_conv_A(c, F) for c in jp.spat), jnp.asarray(sigma),
                   ranks, noise_inject=ns)
    tp = to_torch_params(jp)
    got = engine_general.suff_stats_general(
        batched(X), tp.all_source_powers(),
        tuple(_as_conv_A(c, F) for c in tp.spat), batched(sigma), ranks,
        noise_inject=ns)
    _peak_close(got.xi[0], want.xi, 2e-4)
    for g, w in zip(got.Txs, want.Txs):
        _peak_close(g[0], w, 5e-4)
    for g, w in zip(got.T4, want.T4):
        assert g.shape[1:] == np.shape(w)
        _peak_close(g[0], w, 5e-4)
    for j in range(len(ranks)):
        for k in range(len(ranks)):
            _peak_close(got.Tss[j][k][0], want.Tss[j][k], 5e-4)
            if j != k:
                _peak_close(got.T7[j][k][0], want.T7[j][k], 5e-4)
            else:
                assert got.T7[j][k] is None
    np.testing.assert_allclose(got.loglik[0].item(), float(want.loglik),
                               rtol=1e-5)


@pytest.mark.parametrize("fn", ["separate_sources",
                                "separate_spatial_filter"])
@pytest.mark.parametrize("I,mix,ranks", [(3, "inst", (1, 1)),
                                         (3, "conv", (1, 3)),
                                         (1, "inst", (1, 1))])
def test_separations_match_jax(fn, I, mix, ranks):
    rng = np.random.default_rng(7 + I)
    X, jp, sigma = problem(rng, I=I, mix=mix, ranks=ranks)
    want = np.asarray(getattr(jwiener, fn)(jp, jnp.asarray(X),
                                           jnp.asarray(sigma)))
    got = getattr(wiener, fn)(to_torch_params(jp), batched(X),
                              batched(sigma))
    assert tuple(got.shape) == (1,) + want.shape
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.max(np.abs(want)))


@pytest.mark.parametrize("I,mix,ranks,annealing", [
    (3, "inst", (1, 1, 1), "ann"), (3, "inst", (1, 1, 1), "ann_ns_inj"),
    (3, "conv", (1, 3), "ann"), (1, "inst", (1, 1), "ann_ns_inj")])
def test_run_gem_float32_matches_jax(I, mix, ranks, annealing):
    """10 iterations from the same parameters, through gem_step's dispatch
    (the general engine and the unfused spectral M-step, although the
    config asks for fusion)."""
    rng = np.random.default_rng(3 + I)
    X, jp, _ = problem(rng, F=33, N=40, K=3, I=I, mix=mix, ranks=ranks)
    want_p, want_ll = jgem.run_gem(jp, jnp.asarray(X),
                                   JConfig(niter=10, annealing=annealing))
    got_p, got_ll = gem.run_gem(to_torch_params(jp), batched(X),
                                GEMConfig(niter=10, annealing=annealing,
                                          fuse_spectral=True))
    np.testing.assert_allclose(got_ll[0].numpy(), np.asarray(want_ll),
                               rtol=1e-5)
    pairs = [(tc.A, jc.A) for tc, jc in zip(got_p.spat, want_p.spat)]
    pairs += [(getattr(tc, n), getattr(jc, n))
              for tc, jc in zip(got_p.spec, want_p.spec) for n in ("FB", "TW")]
    for g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g[0].numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.max(np.abs(w)))


def _oracle_case(I, mix, ranks, annealing, niter=8):
    rng = np.random.default_rng(40 + I + len(ranks))
    with enable_x64():
        X, jp, _ = problem(rng, I=I, mix=mix, ranks=ranks, dtype=np.float64)
        oparams = params_from_pytree(jp)
        tp = to_torch_params(jp, torch.float64)
    got_p, got_ll = gem.run_gem(tp, batched(X),
                                GEMConfig(niter=niter, annealing=annealing))
    want_p, want_ll = oracle_gem_run(oparams, X, niter, annealing=annealing)
    return got_p, got_ll, want_p, want_ll


@pytest.mark.parametrize("I,mix,ranks,annealing,a_rtol", [
    (3, "inst", (1, 1), "ann", 1e-5),
    (3, "inst", (1, 1), "ann_ns_inj", 1e-5),
    (3, "conv", (1, 3), "ann", 1e-4),
    (1, "inst", (1, 1), "ann", 1e-5)])
def test_run_gem_float64_matches_oracle(I, mix, ranks, annealing, a_rtol):
    got_p, got_ll, want_p, want_ll = _oracle_case(I, mix, ranks, annealing)
    np.testing.assert_allclose(got_ll[0].numpy(), want_ll, rtol=1e-6)
    for j in range(len(ranks)):
        np.testing.assert_allclose(got_p.spat[j].A[0].numpy(),
                                   want_p.spat[j].A, rtol=a_rtol, atol=1e-8)
        np.testing.assert_allclose(got_p.spec[j].FB[0].numpy(),
                                   want_p.spec[j].FB, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("I", [3, 1])
def test_separation_float64_matches_oracle(I):
    """Wiener images after 5 iterations against the oracle's, and the
    images summing back to the mixture (tests/test_parity.py:306)."""
    rng = np.random.default_rng(50 + I)
    with enable_x64():
        X, jp, _ = problem(rng, I=I, dtype=np.float64)
        oparams = params_from_pytree(jp)
        tp = to_torch_params(jp, torch.float64)
    cfg = GEMConfig(niter=5)
    Xt = batched(X)
    tp, _ = gem.run_gem(tp, Xt, cfg)
    _, sigma1 = gem.annealing_endpoints(Xt, cfg)
    got = wiener.separate_sources(tp, Xt, sigma1)[0].numpy()
    oparams, _ = oracle_gem_run(oparams, X, 5)
    _, osig = np_endpoints(X, 1e-2, 3e-6)
    np.testing.assert_allclose(got, oracle_separate(oparams, X, osig),
                               rtol=5e-5, atol=1e-6)


def test_general_engine_on_cpu_never_takes_the_stereo_paths(monkeypatch):
    """I = 3 on the CPU: no 2x2 E-step, no kernel eligibility check, no
    x4 packing, no fused spectral step, whatever the config asks."""
    def forbidden(*a, **k):
        raise AssertionError("I = 2 path taken at I = 3")
    from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral
    for mod, name in ((gem, "compute_suff_stats"),
                      (cuda_estep, "kernel_eligible"),
                      (cuda_estep, "pack_x4"),
                      (cuda_spectral, "fused_spectral_update")):
        monkeypatch.setattr(mod, name, forbidden)
    rng = np.random.default_rng(5)
    X, jp, _ = problem(rng, I=3)
    _, ll = gem.run_gem(to_torch_params(jp), batched(X),
                        GEMConfig(niter=3, fuse_spectral=True,
                                  fast_recip=True))
    assert bool(torch.isfinite(ll).all())


def _three_channel_mixture(seed=0, fs=16000, dur=1.0):
    """tests/test_multichannel.py's 3-microphone fixture (a harmonic source
    and gated noise at directions [0.9, 0.5, 0.2] and [0.25, 0.6, 0.95])."""
    r = np.random.default_rng(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = 196.0 * 2 ** (0.15 * np.sin(2 * np.pi * 1.1 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    am = 0.5 + 0.5 * np.clip(np.sin(2 * np.pi * 1.7 * t), 0, None)
    s1 = am * sum((0.7 / h) * np.sin(h * phase) for h in range(1, 6))
    gate = (np.sin(2 * np.pi * 2.5 * t) > 0.3).astype(float)
    s2 = gate * r.standard_normal(n) * 0.5
    s1 /= np.abs(s1).max()
    s2 /= np.abs(s2).max()
    y1 = s1[:, None] * np.array([0.9, 0.5, 0.2])
    y2 = s2[:, None] * np.array([0.25, 0.6, 0.95])
    return (y1 + y2).astype(np.float32), y1, y2


@pytest.mark.parametrize("channels", [3, 1])
def test_model_separates_any_channel_count(channels):
    """The host API on 3 channels and on mono (the first channel): finite
    loglik, images of the input's shape that sum back to the mixture
    (tests/test_multichannel.py:46-50), and the spatial-filter variant."""
    import pyfasst_tpu_torch
    mix, _, _ = _three_channel_mixture()
    mix = mix[:, :channels]
    m = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
        mix, fs=16000, wlen=512, iter_num=30, nbComps=2, nbNMFComps=4,
        device="cpu")
    ll = m.estim_param_a_posteriori()
    assert np.all(np.isfinite(ll))
    ys = m.separated_images()
    assert ys.shape == (2, mix.shape[0], channels)
    res = np.linalg.norm(ys.sum(axis=0) - mix) / np.linalg.norm(mix)
    assert res < 5e-2, res
    assert m.separate_spatial_filter_comp(None) == []
