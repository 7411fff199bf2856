"""The port's discrete-state and source-filter models against the JAX
package's: ops/hmm.py (state gains, GMM and HMM posteriors, Viterbi,
state_factor_update), the SIMM and GMM/HMM branches of the spectral
M-step, MultiChanHMM, multiChanSourceF0Filter with its WF0 dictionaries,
models/lead.py, and checkpoints of state models.

Bars: posteriors, gains and state updates rtol 1e-5 on small inputs;
Viterbi and melody paths equal as paths (fixtures with clear margins);
WF0 dictionaries bit for bit (NumPy on both sides); GEM runs as
tests/test_torch_model.py bars them (logliks rtol 1e-4, images within 5e-4
of the peak), from the same parameters carried by convert.py. The model
runs end their annealing at sigma_end_frac 1e-4 (the default 3e-6 makes a
30-iteration run's last step drop the noise floor ~100x at once, where the
two packages' float32 rounding, ~5e-6 of the loglik in every earlier
iteration, grows to ~2e-4 of the loglik and ~2e-3 of the state models'
images; at 1e-4 they stay below 1.5e-5 and 1e-4). The default schedule
is held by the GEM runs on tests/test_hmm.py's fixture and by
tests/test_torch_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.models import lead as jlead
from pyfasst_tpu.models import variants as jvar
from pyfasst_tpu.models.components import SpectralComp as JComp
from pyfasst_tpu.ops import hmm as jhmm
from pyfasst_tpu.ops import mstep as jmstep
from pyfasst_tpu.ops.gem import annealing_endpoints as j_endpoints
from pyfasst_tpu.ops.gem import run_gem as j_run_gem
from pyfasst_tpu.ops.wiener import separate_sources as j_separate
from pyfasst_tpu.utils import checkpoint as jckpt
from pyfasst_tpu.utils.config import GEMConfig as JConfig
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.models import lead, variants
from pyfasst_tpu_torch.models.components import SpectralComp
from pyfasst_tpu_torch.ops import hmm, mstep
from pyfasst_tpu_torch.ops.gem import annealing_endpoints, run_gem
from pyfasst_tpu_torch.ops.wiener import separate_sources
from pyfasst_tpu_torch.utils import checkpoint as tckpt
from pyfasst_tpu_torch.utils.config import GEMConfig
from tests.test_hmm import _hmm_problem
from tests.torch_parity import to_torch_params

torch.set_num_threads(1)


def _t(a):
    """numpy/JAX array -> torch tensor with a clip axis of 1."""
    return torch.as_tensor(np.array(a))[None]


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _peak_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


# -- ops/hmm.py ---------------------------------------------------------------

def test_state_gains_and_loglik_match_jax():
    rng = np.random.default_rng(0)
    P = (0.5 + rng.random((16, 8))).astype(np.float32)
    W = (0.5 + rng.random((16, 3))).astype(np.float32)
    gj, Lj = jhmm._state_gains_and_loglik(jnp.asarray(P), jnp.asarray(W),
                                          1e-30)
    g, L = hmm._state_gains_and_loglik(_t(P), _t(W), 1e-30)
    _close(g, gj, 1e-5)
    _close(L, Lj, 1e-5)


def test_gmm_and_hmm_posteriors_match_jax():
    rng = np.random.default_rng(1)
    Q, N = 4, 30
    L = rng.standard_normal((Q, N)).astype(np.float32) * 3
    prior = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    trans = rng.dirichlet(np.ones(Q), size=Q).astype(np.float32)
    want = jhmm._gmm_posteriors(jnp.asarray(L), jnp.log(prior))
    _close(hmm._gmm_posteriors(_t(L), _t(np.log(prior))), want, 1e-5)
    want = jhmm._hmm_posteriors(jnp.asarray(L), jnp.log(trans))
    got = hmm._hmm_posteriors(_t(L), _t(np.log(trans)))
    _close(got, want, 1e-5, atol=1e-7)
    np.testing.assert_allclose(got[0].sum(0).numpy(), 1.0, rtol=1e-5)


def test_posteriors_batch_by_clip():
    """B clips at once give each clip's own B = 1 result."""
    rng = np.random.default_rng(2)
    L = torch.as_tensor(rng.standard_normal((3, 4, 25)), dtype=torch.float32)
    T = torch.as_tensor(rng.dirichlet(np.ones(4), size=(3, 4)),
                        dtype=torch.float32).log()
    gam, path = hmm._hmm_posteriors(L, T), hmm.viterbi_path(L, T)
    for b in range(3):
        assert torch.allclose(gam[b], hmm._hmm_posteriors(L[b:b + 1],
                                                          T[b:b + 1])[0])
        assert torch.equal(path[b], hmm.viterbi_path(L[b:b + 1],
                                                     T[b:b + 1])[0])


def _clear_chain(seed, Q=4, N=60):
    """Log-likelihoods with a clear best state per frame along a sticky
    path, and a sticky transition matrix."""
    rng = np.random.default_rng(seed)
    path = np.repeat(rng.integers(0, Q, N // 6 + 1), 6)[:N]
    L = rng.standard_normal((Q, N)) * 0.3
    L[path, np.arange(N)] += 4.0
    trans = 0.8 * np.eye(Q) + 0.2 / (Q - 1) * (1 - np.eye(Q))
    return L.astype(np.float32), np.log(trans).astype(np.float32), path


@pytest.mark.parametrize("seed", [3, 4])
def test_viterbi_path_equals_jax(seed):
    L, logT, truth = _clear_chain(seed)
    want = np.asarray(jhmm.viterbi_path(jnp.asarray(L), jnp.asarray(logT)))
    got = hmm.viterbi_path(_t(L), _t(logT))[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, truth)


def test_viterbi_melody_equals_jax():
    U, N = 40, 60
    true_path = (20 + 8 * np.sin(np.linspace(0, 3, N))).astype(int)
    sal = np.full((U, N), 0.01, np.float32)
    sal[true_path, np.arange(N)] = 1.0
    want = np.asarray(jlead.viterbi_melody(jnp.asarray(sal)))
    got = lead.viterbi_melody(_t(sal))[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert np.mean(np.abs(got - true_path) <= 1) > 0.9


@pytest.mark.parametrize("kind", ["GMM", "HMM", "viterbi"])
def test_state_factor_update_matches_jax(kind):
    rng = np.random.default_rng(5)
    F, Q, N = 24, 3, 40
    FB = (0.5 + rng.random((F, Q))).astype(np.float32)
    FB[:8, 0] += 4.0
    FB[8:16, 1] += 4.0
    TW = (0.5 + rng.random((Q, N))).astype(np.float32)
    P = (0.5 + rng.random((F, N))).astype(np.float32)
    P[:8, :20] += 6.0
    P[8:16, 20:] += 6.0
    if kind == "GMM":
        trans = np.full(Q, 1.0 / Q, np.float32)
    else:
        trans = (0.8 * np.eye(Q) + 0.1 * (1 - np.eye(Q))).astype(np.float32)
    kw = dict(constraint="GMM" if kind == "GMM" else "HMM",
              decode="viterbi" if kind == "viterbi" else "soft")
    jc = JComp(FB=jnp.asarray(FB), TW=jnp.asarray(TW),
               trans=jnp.asarray(trans), **kw)
    tc = SpectralComp(FB=_t(FB), TW=_t(TW), trans=_t(trans), **kw)
    V = (0.3 + rng.random((F, N))).astype(np.float32) + FB @ TW
    jc2, jV = jhmm.state_factor_update(jc, jnp.asarray(P), jnp.asarray(V))
    tc2, tV = hmm.state_factor_update(tc, _t(P), _t(V))
    # a state whose posterior is ~1e-7 carries the float32 rounding of the
    # log scores it is the exponent of: absolute floor 1e-7 of the gains
    _close(tc2.TW, jc2.TW, 1e-5, atol=1e-7 * float(jc2.TW.max()))
    _close(tV, jV, 1e-5)


def test_simm_factor_updates_match_jax():
    rng = np.random.default_rng(6)
    F, N, U, G = 40, 30, 12, 5
    arrays = dict(FB=0.1 + rng.random((F, U)), TW=0.5 + rng.random((U, N)),
                  FB2=0.1 + rng.random((F, G)), TW2=0.5 + rng.random((G, N)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    kw = dict(free=(False, False, True, False), free2=(True, True))
    jc = JComp(**{k: jnp.asarray(v) for k, v in arrays.items()}, **kw)
    tc = SpectralComp(**{k: _t(v) for k, v in arrays.items()}, **kw)
    P = (0.5 + rng.random((F, N))).astype(np.float32)
    jV, tV = jc.power(), tc.power()
    for _ in range(3):
        jc, jV = jmstep._simm_factor_updates(jc, jnp.asarray(P), jV, 1e-30)
        tc, tV = mstep._simm_factor_updates(tc, _t(P), tV, 1e-30)
    for name in ("TW", "FB2", "TW2"):
        _close(getattr(tc, name), getattr(jc, name), 1e-4)
    # the scale pushed into a SIMM component with no free first chain lands
    # on its first free factor of the second
    s = torch.tensor([2.0])
    lead_only = tc.replace(free=(False,) * 4, free2=(False, True))
    scaled = mstep._scale_first_free(lead_only, s)
    assert torch.equal(scaled.TW2, 2.0 * tc.TW2)
    assert torch.equal(scaled.TW, tc.TW)


# -- GEM over state models ----------------------------------------------------

def _gem_both(jparams, X, niter):
    Xj = jnp.asarray(X, jnp.complex64)
    jcfg = JConfig(niter=niter)
    jp, jll = j_run_gem(jparams, Xj, jcfg)
    Yj = np.asarray(j_separate(jp, Xj, j_endpoints(Xj, jcfg)[1]))
    Xt = torch.as_tensor(X.astype(np.complex64))[None]
    cfg = GEMConfig(niter=niter)
    tp, tll = run_gem(to_torch_params(jparams), Xt, cfg)
    Yt = separate_sources(tp, Xt, annealing_endpoints(Xt, cfg)[1])[0]
    return np.asarray(jll), tll[0].numpy(), Yj, Yt.numpy(), jp, tp


@pytest.mark.parametrize("kind", ["HMM", "GMM", "viterbi"])
def test_run_gem_state_models_match_jax(kind):
    X, _, jparams = _hmm_problem(np.random.default_rng(0),
                                 "GMM" if kind == "GMM" else "HMM")
    if kind == "viterbi":
        jparams = jparams.replace(spec=(
            jparams.spec[0].replace(decode="viterbi"), jparams.spec[1]))
    jll, tll, Yj, Yt, jp, tp = _gem_both(jparams, X, 30)
    assert np.all(np.isfinite(tll))
    np.testing.assert_allclose(tll, jll, rtol=1e-4)
    assert _peak_err(Yt, Yj) < 5e-4
    assert tp.spec[0].constraint == jp.spec[0].constraint
    assert tp.spec[0].decode == jp.spec[0].decode
    _close(tp.spec[0].trans, jp.spec[0].trans, 0)


# -- variants ------------------------------------------------------------------

def test_wf0_dictionaries_equal_jax():
    args = (257, 16000, 512)
    np.testing.assert_array_equal(
        variants.generate_WF0(*args, n_f0=30),
        jvar.generate_WF0(*args, n_f0=30))
    np.testing.assert_array_equal(
        variants.generate_WF0_chirped(*args, n_f0=20, chirp_per_f0=3),
        jvar.generate_WF0_chirped(*args, n_f0=20, chirp_per_f0=3))
    np.testing.assert_array_equal(variants.odgd_harmonic_amplitudes(12),
                                  jvar.odgd_harmonic_amplitudes(12))


def _switch_mixture(seed, fs=8000, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    gate = (np.sin(2 * np.pi * 2 * t) > 0)
    s1 = np.where(gate, np.sin(2 * np.pi * 300 * t),
                  np.sin(2 * np.pi * 900 * t))
    s2 = 0.3 * rng.standard_normal(t.size)
    return (np.outer(s1, [0.9, 0.35])
            + np.outer(s2, [0.35, 0.9])).astype(np.float32)


@pytest.mark.parametrize("mix_type,sparsity,decode", [
    ("inst", "HMM", "soft"), ("conv", "GMM", "soft"),
    ("inst", "HMM", "viterbi")])
def test_multichan_hmm_matches_jax(mix_type, sparsity, decode):
    mix = _switch_mixture(7)
    kw = dict(fs=8000, nbComps=2, nbStates=3, wlen=256, iter_num=30,
              sparsity=sparsity, mix_type=mix_type, decode=decode,
              self_trans=0.95, sigma_end_frac=1e-4)
    jm = jvar.MultiChanHMM(mix, **kw)
    tm = variants.MultiChanHMM(mix, device="cpu", **kw)
    c = tm.params.spec[0]
    assert c.constraint == sparsity and c.decode == decode
    assert tuple(c.FB.shape) == (1, tm.F, 3)
    assert tuple(c.trans.shape) == ((1, 3, 3) if sparsity == "HMM"
                                    else (1, 3))
    _close(c.trans, jm.params.spec[0].trans, 0)
    _close(tm.params.spat[0].A, jm.params.spat[0].A, 0)
    tm.params = convert.params_from_numpy(jax.tree.map(np.asarray,
                                                       jm.params))
    jll = jm.estim_param_a_posteriori()
    tll = tm.estim_param_a_posteriori()
    np.testing.assert_allclose(tll, jll, rtol=1e-4)
    assert _peak_err(tm.separated_images(), jm.separated_images()) < 5e-4


def test_source_filter_model_matches_jax():
    mix = _switch_mixture(8)
    kw = dict(fs=8000, nbComps=2, nbNMFComps=3, wlen=512, n_f0=30,
              f0_min=100, f0_max=600, n_filter_bands=8, iter_num=30,
              sigma_end_frac=1e-4)
    jm = jvar.multiChanSourceF0Filter(mix, **kw)
    tm = variants.multiChanSourceF0Filter(mix, device="cpu", **kw)
    c, jc = tm.params.spec[0], jm.params.spec[0]
    assert c.free == jc.free and c.free2 == jc.free2
    _close(c.FB, jc.FB, 0)
    _close(c.FB2, jc.FB2, 0)
    tm.params = convert.params_from_numpy(jax.tree.map(np.asarray,
                                                       jm.params))
    jll = jm.estim_param_a_posteriori()
    tll = tm.estim_param_a_posteriori()
    np.testing.assert_allclose(tll, jll, rtol=1e-4)
    assert _peak_err(tm.separated_images(), jm.separated_images()) < 5e-4


def test_state_models_need_the_stft_and_default_to_the_card(monkeypatch):
    from pyfasst_tpu_torch.tf import ERBLetTransform
    tft = ERBLetTransform(fs=8000, n_bands=24, device="cpu")
    with pytest.raises(ValueError, match="STFT front-end"):
        variants.multiChanSourceF0Filter(np.zeros((4000, 2), np.float32),
                                         fs=8000, transform=tft,
                                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        variants.MultiChanHMM(np.zeros((4000, 2)), fs=8000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lead.SeparateLeadStereoTF(audio=np.zeros((4000, 2)), fs=8000)


# -- lead ------------------------------------------------------------------

def _vibrato(seed, fs=8000, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    f0 = 220 * 2 ** (0.25 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    lead_s = sum((0.5 / h) * np.sin(h * phase) for h in range(1, 6))
    acc = 0.05 * rng.standard_normal(t.size)
    return np.stack([0.8 * lead_s + 0.7 * acc, 0.6 * lead_s + 0.8 * acc],
                    axis=1).astype(np.float32)


def test_simm_updates_match_jax():
    rng = np.random.default_rng(9)
    F, N, U, G, M = 32, 24, 10, 4, 3
    a = dict(P=0.5 + rng.random((F, N)), WF0=0.1 + rng.random((F, U)),
             WG=0.1 + rng.random((F, G)), HF0=0.5 + rng.random((U, N)),
             HG=0.5 + rng.random((G, N)), WM=0.5 + rng.random((F, M)),
             HM=0.5 + rng.random((M, N)))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    want = jlead.simm_updates(*(jnp.asarray(v) for v in a.values()), 5)
    got = lead.simm_updates(*(_t(v) for v in a.values()), 5)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_separate_lead_stereo_matches_jax(tmp_path):
    mix = _vibrato(10)
    kw = dict(audio=mix, fs=8000, wlen=512, niter=8, n_f0=30, f0_min=100,
              f0_max=500, n_filter=8, n_acc=4, chirp_per_f0=2)
    js = jlead.SeparateLeadStereoTF(**kw)
    ts = lead.SeparateLeadStereoTF(device="cpu", **kw)
    _close(ts.HF0, js.HF0, 0)
    _close(ts.WF0, js.WF0, 0)
    jmel = js.runDecomposition()
    tmel = ts.runDecomposition()
    np.testing.assert_array_equal(tmel, jmel)
    _close(ts.f0_activations, js.f0_activations, 1e-3, atol=1e-6)
    np.testing.assert_allclose(ts.alpha, js.alpha, rtol=1e-4)
    for g, w in zip(ts.separated_signals(), js.separated_signals()):
        assert _peak_err(g, w) < 5e-4
    p1, p2 = ts.writeSeparatedSignals(str(tmp_path))
    assert p1.endswith("_lead.wav") and p2.endswith("_accompaniment.wav")


def test_init_from_lead_matches_jax():
    mix = _vibrato(11)
    kw = dict(fs=8000, nbComps=2, nbNMFComps=3, wlen=512, n_f0=30,
              f0_min=100, f0_max=500, n_filter_bands=8, iter_num=4,
              init_from_lead=True, lead_iters=4)
    jm = jvar.multiChanSourceF0Filter(mix, **kw)
    tm = variants.multiChanSourceF0Filter(mix, device="cpu", **kw)
    np.testing.assert_array_equal(tm.lead_melody, jm.lead_melody)
    _close(tm.params.spec[0].TW, jm.params.spec[0].TW, 1e-3, atol=1e-6)
    _close(tm.params.spec[0].TW2, jm.params.spec[0].TW2, 1e-3)


# -- checkpoints ----------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_hmm_checkpoint_read_by_the_other_package(tmp_path, writer):
    mix = _switch_mixture(12)
    jm = jvar.MultiChanHMM(mix, fs=8000, nbStates=3, wlen=256,
                           decode="viterbi", sparsity="HMM")
    path = str(tmp_path / "ck.npz")
    if writer == "jax":
        jckpt.save_params(path, jm.params, iteration=7)
        params, it, _ = tckpt.load_params(path, device="cpu")
        got = convert.params_to_numpy(params)[0]
        want = jax.tree.map(np.asarray, jm.params)
    else:
        tparams = convert.params_from_numpy(jax.tree.map(np.asarray,
                                                         jm.params))
        tckpt.save_params(path, tparams, iteration=7)
        jp, it, _ = jckpt.load_params(path)
        got = jax.tree.map(np.asarray, jp)
        want = convert.params_to_numpy(tparams)[0]
    assert it == 7
    for cg, cw in zip(convert.as_tree(got)["spec"],
                      convert.as_tree(want)["spec"]):
        for name in ("FB", "TW", "trans"):
            np.testing.assert_array_equal(cg[name], cw[name])
        for name in ("constraint", "decode", "free", "free2"):
            assert cg[name] == cw[name]
