"""The port's front-ends against the JAX package's: the ERBlet and
multi-rate ERBlet transforms, MinQT, the ERB filterbank front-end and
MelBank, the STFT's "matmul" method, WPE dereverberation, and FASST over
a warped front-end.

Bars: the ERBlet geometry (N, Tp, idx, W, Wd) equal exactly; coefficient
planes and resyntheses within 1e-5 of the plane's peak (float32 FFTs of
two libraries); ERBlet round trip below 1e-5 (tests/test_erblet.py's bar);
MinQT and ERBTransform within 1e-5 of the peak; WPE bit for bit (NumPy on
both sides); FASST over a warped front-end as tests/test_torch_model.py
bars the STFT model: logliks rtol 1e-4, images within 5e-4 of the peak.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.models.variants import MultiChanNMFInst_FASST as JModel
from pyfasst_tpu.tf import erblet as jerb
from pyfasst_tpu.tf import filterbank as jfb
from pyfasst_tpu.tf import minqt as jmq
from pyfasst_tpu.tf.dereverb import wpe_dereverb as j_wpe
from pyfasst_tpu.tf.stft import _stft_core as j_stft
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.models.variants import MultiChanNMFInst_FASST
from pyfasst_tpu_torch.tf import (
    ERBLetTransform, ERBTransform, MelBank, MinQTransfo, MultiRateERBLet,
    stft, wpe_dereverb,
)
from pyfasst_tpu_torch.tf.stft import _stft_core, sine_window

torch.set_num_threads(1)


def _signal(seed, T, channels):
    x = np.random.default_rng(seed).standard_normal(
        (T, channels)).astype(np.float32)
    return x[:, 0] if channels == 1 else x


def _peak_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- ERBlet --------------------------------------------------------------------

@pytest.mark.parametrize("scale", ["erb", "log"])
@pytest.mark.parametrize("T", [16000, 12345])
def test_erblet_geometry_equals_jax(scale, T):
    j = jerb.ERBLetTransform(fs=16000, n_bands=40, scale=scale)._geometry(T)
    t = ERBLetTransform(fs=16000, n_bands=40, scale=scale,
                        device="cpu")._geometry(T)
    assert (t["N"], t["Tp"], t["K"]) == (j["N"], j["Tp"], j["K"])
    np.testing.assert_array_equal(t["idx"], np.asarray(j["idx"]))
    np.testing.assert_array_equal(t["m"], np.asarray(j["m"]))
    np.testing.assert_array_equal(t["W"], np.asarray(j["W"]))
    np.testing.assert_array_equal(t["Wd"], np.asarray(j["Wd"]))


def test_erblet_geometry_at_erblet48():
    """The chip smoke's erblet48 plane: 10 s at 44.1 kHz, 48 bands."""
    T = 441000
    j = jerb.ERBLetTransform(fs=44100, n_bands=48)._geometry(T)
    t = ERBLetTransform(fs=44100, n_bands=48, device="cpu")._geometry(T)
    assert (t["N"], t["Tp"]) == (j["N"], j["Tp"]) == (98304, 491520)
    np.testing.assert_array_equal(t["Wd"], np.asarray(j["Wd"]))


@pytest.mark.parametrize("scale", ["erb", "log"])
@pytest.mark.parametrize("channels", [1, 2])
def test_erblet_analysis_and_synthesis_match_jax(scale, channels):
    x = _signal(1, 12345, channels)
    jt = jerb.ERBLetTransform(fs=16000, n_bands=40, scale=scale)
    tt = ERBLetTransform(fs=16000, n_bands=40, scale=scale, device="cpu")
    Cj = np.asarray(jt.computeTransform(x))
    Ct = tt.computeTransform(x)
    assert Ct.dtype == torch.complex64
    assert _peak_err(Ct, Cj) < 1e-5
    # the same coefficients through both inverses
    yj = np.asarray(jt.invertTransform(Cj))
    yt = tt.invertTransform(torch.as_tensor(np.array(Cj)))
    assert _peak_err(yt, yj) < 1e-5
    assert _peak_err(tt.invertTransform(Ct), x) < 1e-5       # round trip


def test_erblet_leading_axes_and_repeatable():
    """(J, B, N, I) coefficients invert source by source (to FFT rounding:
    a batched FFT may order its sums otherwise), and the gather synthesis
    gives the same bits on every run."""
    x = _signal(2, 8000, 2)
    tt = ERBLetTransform(fs=16000, n_bands=32, device="cpu")
    C = tt.computeTransform(x)
    Cs = torch.stack([C, 0.5 * C, C.conj()])
    ys = tt.invertTransform(Cs)
    assert ys.shape == (3, 8000, 2)
    for j in range(3):
        assert _peak_err(ys[j], tt.invertTransform(Cs[j])) < 1e-6
    assert torch.equal(tt.invertTransform(Cs), ys)


@pytest.mark.parametrize("channels", [1, 2])
def test_multirate_erblet_matches_jax(channels):
    x = _signal(3, 6000, channels)
    jt = jerb.MultiRateERBLet(fs=8000, n_bands=24)
    tt = MultiRateERBLet(fs=8000, n_bands=24, device="cpu")
    Cj = [np.asarray(c) for c in jt.computeTransform(x)]
    Ct = tt.computeTransform(x)
    assert len(Ct) == len(Cj) > 1
    for gj, gt in zip(jt._geometry(6000)["groups"],
                      tt._geometry(6000)["groups"]):
        assert (gt["d"], gt["N"]) == (gj["d"], gj["N"])
        np.testing.assert_array_equal(gt["bands_np"], gj["bands_np"])
        np.testing.assert_array_equal(gt["Wd"], np.asarray(gj["Wd"]))
    for a, b in zip(Ct, Cj):
        assert _peak_err(a, b) < 1e-5
    for a, b in zip(tt.group_bands, jt.group_bands):
        np.testing.assert_array_equal(a, b)
    yj = np.asarray(jt.invertTransform(Cj))
    yt = tt.invertTransform([torch.as_tensor(np.array(c)) for c in Cj])
    assert _peak_err(yt, yj) < 1e-5
    assert _peak_err(tt.invertTransform(Ct), x) < 1e-5
    assert tt.redundancy(6000) == jt.redundancy(6000)


def test_erblet_guards():
    with pytest.raises(ValueError, match="scale"):
        ERBLetTransform(fs=16000, scale="mel", device="cpu")
    bad = ERBLetTransform(fs=16000, n_bands=64, hop=4096, device="cpu")
    with pytest.raises(ValueError, match="hop"):
        bad.computeTransform(np.zeros(16000, np.float32))
    with pytest.raises(ValueError, match="power of two"):
        MultiRateERBLet(fs=16000, max_decimation=3, device="cpu")
    j = jerb.ERBLetTransform(fs=16000, n_bands=64)
    t = ERBLetTransform(fs=16000, n_bands=64, device="cpu")
    assert t.frame_bounds(16000) == j.frame_bounds(16000)
    np.testing.assert_array_equal(t.band_centers(), j.band_centers())


# -- MinQT, ERBTransform, MelBank ---------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
def test_minqt_matches_jax(channels):
    x = _signal(4, 5000, channels)
    kw = dict(fs=8000, wlen=1024, n_bins=48, fmin=60, fmax=3500)
    jt = jmq.MinQTransfo(**kw)
    tt = MinQTransfo(device="cpu", **kw)
    np.testing.assert_array_equal(tt.K, jt.K)
    np.testing.assert_array_equal(tt.dual_real, jt.dual_real)
    Xj = np.asarray(jt.computeTransform(x))
    Xt = tt.computeTransform(x)
    assert _peak_err(Xt, Xj) < 1e-5
    yj = np.asarray(jt.invertTransform(Xj))
    yt = tt.invertTransform(torch.as_tensor(np.array(Xj)))
    assert _peak_err(yt, yj) < 1e-5


@pytest.mark.parametrize("channels", [1, 2])
def test_erb_transform_matches_jax(channels):
    x = _signal(5, 8000, channels)
    kw = dict(n_bands=40, wlen=512, fs=16000)
    jt = jfb.ERBTransform(**kw)
    tt = ERBTransform(device="cpu", **kw)
    np.testing.assert_array_equal(tt.dual, jt.dual)
    Xj = np.asarray(jt.computeTransform(x))
    Xt = tt.computeTransform(x)
    assert _peak_err(Xt, Xj) < 1e-5
    yj = np.asarray(jt.invertTransform(Xj, nsamples=8000))
    yt = tt.invertTransform(torch.as_tensor(Xj.astype(np.complex64)),
                            nsamples=8000)
    assert _peak_err(yt, yj) < 1e-5


def test_melbank_matches_jax():
    P = np.random.default_rng(6).random((257, 30)).astype(np.float32)
    jb = jfb.MelBank(24, 257, 16000, 512)
    tb = MelBank(24, 257, 16000, 512)
    np.testing.assert_array_equal(tb.bank, jb.bank)
    np.testing.assert_array_equal(tb(P), jb(P))
    assert _peak_err(tb(torch.as_tensor(P)), jb(P)) < 1e-6


# -- STFT "matmul" method ----------------------------------------------------

@pytest.mark.parametrize("wlen,hop", [(256, 128), (256, 96)])
@pytest.mark.parametrize("channels", [1, 2])
def test_stft_matmul_matches_jax_and_fft(wlen, hop, channels):
    x = _signal(7, 4000, channels)
    win = sine_window(wlen).astype(np.float32)
    want = np.asarray(j_stft(jnp.asarray(x), jnp.asarray(win), wlen, hop,
                             "matmul"))
    got = _stft_core(torch.as_tensor(x), torch.as_tensor(win), wlen, hop,
                     "matmul")
    assert _peak_err(got, want) < 2e-6
    assert _peak_err(got, stft(x, wlen, hop, device="cpu")) < 2e-6


# -- WPE --------------------------------------------------------------------

def test_wpe_dereverb_bit_for_bit():
    rng = np.random.default_rng(8)
    X = (rng.standard_normal((9, 40, 2))
         + 1j * rng.standard_normal((9, 40, 2))).astype(np.complex64)
    np.testing.assert_array_equal(wpe_dereverb(X, order=4, delay=2),
                                  j_wpe(X, order=4, delay=2))
    np.testing.assert_array_equal(wpe_dereverb(X[:, :5]), X[:, :5])


# -- FASST over a warped front-end -------------------------------------------

def _mixture(seed, fs, T):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    s1 = np.sin(2 * np.pi * 320 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
    s2 = rng.standard_normal(T) * (np.sin(2 * np.pi * 1.1 * t) > 0)
    return (np.outer(s1, [0.95, 0.31])
            + np.outer(s2, [0.31, 0.95])).astype(np.float32)


@pytest.mark.parametrize("front", ["erblet", "minqt"])
def test_fasst_over_warped_front_end_matches_jax(front):
    fs, T = 8000, 6000
    mix = _mixture(9, fs, T)
    if front == "erblet":
        jt = jerb.ERBLetTransform(fs=fs, n_bands=32)
        tt = ERBLetTransform(fs=fs, n_bands=32, device="cpu")
    else:
        kw = dict(fs=fs, wlen=1024, n_bins=36, fmin=60, fmax=3500)
        jt, tt = jmq.MinQTransfo(**kw), MinQTransfo(device="cpu", **kw)
    kw = dict(fs=fs, nbComps=2, nbNMFComps=4, iter_num=30)
    jm = JModel(mix, transform=jt, **kw)
    tm = MultiChanNMFInst_FASST(mix, transform=tt, device="cpu", **kw)
    assert tm.F == jm.F and tm.N == jm.N
    assert _peak_err(tm.Xs[0], jm.Xs) < 1e-5
    tm.params = convert.params_from_numpy(jax.tree.map(np.asarray,
                                                       jm.params))
    jll = jm.estim_param_a_posteriori()
    tll = tm.estim_param_a_posteriori()
    assert np.all(np.isfinite(tll))
    np.testing.assert_allclose(tll, jll, rtol=1e-4)
    want = np.asarray(jm.separated_images())
    got = tm.separated_images()
    assert got.shape == want.shape == (2, T, 2)
    assert _peak_err(got, want) < 5e-4


def test_tf_method_erblet_and_cx():
    fs = 8000
    mix = _mixture(10, fs, 4000)
    jm = JModel(mix, fs=fs, tf_method="erblet", iter_num=2)
    tm = MultiChanNMFInst_FASST(mix, fs=fs, tf_method="erblet", iter_num=2,
                                device="cpu")
    assert isinstance(tm.tft, ERBLetTransform) and tm.tft.n_bands == 64
    assert tm.F == jm.F == 64 and tm.N == jm.N
    assert _peak_err(tm.Cx[0], jm.Cx) < 2e-5


@pytest.mark.parametrize("front", ["erblet", "minqt"])
def test_freq_basis_guard_on_warped_front_end(front):
    tft = (ERBLetTransform(fs=8000, n_bands=32, device="cpu")
           if front == "erblet" else
           MinQTransfo(fs=8000, wlen=1024, n_bins=24, fmin=60, fmax=3500,
                       device="cpu"))
    with pytest.raises(ValueError, match="STFT front-end"):
        MultiChanNMFInst_FASST(np.zeros((4000, 2), np.float32), fs=8000,
                               freq_basis="erb", transform=tft,
                               device="cpu")


@pytest.mark.parametrize("cls", [ERBLetTransform, MultiRateERBLet,
                                 MinQTransfo, ERBTransform])
def test_front_ends_default_to_the_card(monkeypatch, cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(fs=16000)
