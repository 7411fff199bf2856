"""The blind mono init on the port against the JAX package.

models/mono.py is NumPy in both packages (is_nmf, _kmeans_corr and
nmf_cluster_init copied as they are): on the same input and seed they
give the same bits. FASST.estim_param_blind_mono and separate_streaming
(init="blind") on mono input are held end to end: images within 5e-4 of
their peak (test_torch_model.py's bar), logliks rtol 1e-4, from the same
initial mixing (the JAX model's, copied in through convert).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import pyfasst_tpu
import pyfasst_tpu.native
from pyfasst_tpu.models import mono as jmono
from pyfasst_tpu.models import streaming as jstreaming
from pyfasst_tpu.tf.stft import STFT as JSTFT
import pyfasst_tpu_torch
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.audio import wavwrite
from pyfasst_tpu_torch.models import mono, streaming

torch.set_num_threads(1)

FS = 8000
IMG_TOL = 5e-4


def _mono_mixture(seconds, seed=0):
    """tests/test_online.py's mono fixture: a vibrato-free harmonic tone
    and gated smoothed noise. (n, 1), scaled below full scale."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    t = np.arange(n) / FS
    s1 = sum(np.sin(2 * np.pi * 220 * (k + 1) * t) / (k + 1)
             for k in range(4)) * (1 + 0.4 * np.sin(2 * np.pi * 1.5 * t))
    s2 = np.convolve(rng.standard_normal(n), np.ones(16) / 16,
                     "same") * (np.sin(2 * np.pi * 0.9 * t) > 0)
    mix = (s1 / s1.std() + s2 / s2.std())[:, None]
    return mix / (np.abs(mix).max() * 1.05)


def _spectrogram(seed=1, F=65, N=90):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((F, N)) + 1j * rng.standard_normal((F, N))
    X[:20, ::3] *= 6.0                       # a gated low band
    return X


def test_is_nmf_equals_jax():
    P = np.abs(_spectrogram()) ** 2
    got = mono.is_nmf(P, 5, iters=50, seed=3)
    want = jmono.is_nmf(P, 5, iters=50, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("J", [2, 3])
def test_nmf_cluster_init_equals_jax(J):
    X = _spectrogram(seed=J)
    got = mono.nmf_cluster_init(X[..., None], J, 3, nmf_iters=60, seed=J)
    want = jmono.nmf_cluster_init(X[..., None], J, 3, nmf_iters=60, seed=J)
    assert len(got) == len(want) == J
    for (gW, gH), (wW, wH) in zip(got, want):
        assert gW.shape == (65, 3) and gH.shape == (3, 90)
        np.testing.assert_array_equal(gW, wW)
        np.testing.assert_array_equal(gH, wH)


@pytest.fixture(scope="module")
def blind_mono_models():
    mix = _mono_mixture(3.0).astype(np.float32)
    kw = dict(fs=FS, nbComps=2, nbNMFComps=4, wlen=512, iter_num=40,
              seed=0)
    jm = pyfasst_tpu.MultiChanNMFInst_FASST(mix, **kw)
    tm = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device="cpu", **kw)
    tm.params = convert.params_from_numpy(jax.tree.map(np.asarray,
                                                       jm.params))
    jll = jm.estim_param_blind_mono(nmf_iters=100)
    tll = tm.estim_param_blind_mono(nmf_iters=100)
    return jm, tm, np.asarray(jll), tll


def test_estim_param_blind_mono_matches_jax(blind_mono_models):
    jm, tm, jll, tll = blind_mono_models
    assert tll.shape == jll.shape == (40,) and np.all(np.isfinite(tll))
    np.testing.assert_allclose(tll, jll, rtol=1e-4)
    yj = np.asarray(jm.separated_images())
    yt = tm.separated_images()
    assert yt.shape == yj.shape == (2, 3 * FS, 1)
    assert np.max(np.abs(yt - yj)) <= IMG_TOL * np.max(np.abs(yj))


def test_apply_mono_init_installs_the_init(blind_mono_models):
    """The init's FB/TW land on the model as float32 with the clip axis;
    a shape that does not fit raises."""
    tm = blind_mono_models[1]
    init = mono.nmf_cluster_init(tm.Xs[0].numpy(), 2, 4, nmf_iters=20)
    params = mono.apply_mono_init(tm.params, init)
    for sc, (W, H) in zip(params.spec, init):
        assert sc.FB.dtype == torch.float32 and sc.FB.shape == (1,) + W.shape
        np.testing.assert_array_equal(sc.FB[0].numpy(), W.astype(np.float32))
        np.testing.assert_array_equal(sc.TW[0].numpy(), H.astype(np.float32))
    with pytest.raises(ValueError, match="shape mismatch for source 0"):
        mono.apply_mono_init(tm.params, [(W[:, :3], H[:3]) for W, H in init])


def test_estim_param_blind_mono_needs_mono_input():
    rng = np.random.default_rng(0)
    m = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
        rng.standard_normal((4000, 2)) * 0.1, fs=FS, nbComps=2,
        nbNMFComps=2, wlen=256, iter_num=2, device="cpu")
    with pytest.raises(ValueError, match="needs mono input"):
        m.estim_param_blind_mono()


@contextlib.contextmanager
def _record_prefix_inits(inits):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyfasst_tpu.native, "_wavio_tried", True)
        mp.setattr(pyfasst_tpu.native, "_wavio_mod", None)
        for name, mod in (("jax", jstreaming), ("torch", streaming)):
            def record(*a, _name=name, _real=mod._blind_prefix_init):
                inits[_name] = _real(*a)
                return inits[_name]
            mp.setattr(mod, "_blind_prefix_init", record)
        yield


def test_separate_streaming_blind_mono_matches_jax(tmp_path):
    """Mono + init="blind" seeds FB from nmf_cluster_init on the prefix.
    Given the JAX package's prefix blocks, the port's seed is the JAX
    package's bit for bit; from its own blocks (1.7e-7 of the peak from
    the JAX package's, float32 FFT rounding) 200 float64 IS-NMF iterations
    carry that to ~2e-3 of the seed's entries, and the images still agree
    within the end-to-end bar (measured 1.6e-4 of the peak; 3.6e-7 from
    the JAX package's own prefix)."""
    path = str(tmp_path / "mono.wav")
    wavwrite(_mono_mixture(6.0), FS, path)
    kw = dict(J=2, K=6, wlen=512, frames_per_block=32, verbose=0,
              init="blind", init_seconds=2.0)
    inits = {}
    with _record_prefix_inits(inits):
        yj, ij = jstreaming.separate_streaming(path, **kw)
        yt, it = streaming.separate_streaming(path, device="cpu", **kw)
    (jA, jFB, _), (tA, tFB, _) = inits["jax"], inits["torch"]
    assert jA is None and tA is None and tFB.shape == (2, 257, 6)
    with _record_prefix_inits({}):
        blocks = JSTFT(wlen=512, fs=FS).stream_blocks(path, 32)
        X = np.concatenate([np.asarray(next(blocks)) for _ in range(2)],
                           axis=1)                  # the 2 s prefix
    groups = mono.nmf_cluster_init(X[..., 0], 2, 6, seed=0)
    np.testing.assert_array_equal(
        np.stack([g[0] * np.maximum(g[1].mean(1), 1e-12) for g in groups]),
        jFB)
    assert yt.shape == np.asarray(yj).shape == (2, 6 * FS, 1)
    assert np.all(np.isfinite(yt))
    assert np.max(np.abs(yt - np.asarray(yj))) <= IMG_TOL * np.max(
        np.abs(yj))
    np.testing.assert_allclose(it["logliks"], ij["logliks"], rtol=1e-4)
