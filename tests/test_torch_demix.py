"""The port's host-side initializers against the JAX package: the ERB/Mel
spectral bases (tf/filterbank.py) and DEMIX (models/demix.py).

Both are NumPy code copied into the port, so on the same inputs they give
the same numbers: the filterbanks and DEMIX run from a given STFT plane are
held bit for bit. DEMIX run from audio goes through each package's own
float32 STFT (the planes agree to ~1e-7 of their peak,
tests/test_torch_stft.py), so there gains, delays and mixing(F) are held to
1e-5 and the cluster labels must be the same.
"""
import numpy as np
import pytest
import torch

from pyfasst_tpu.models import demix as j_demix
from pyfasst_tpu.tf.filterbank import spectral_basis as j_spectral_basis
from pyfasst_tpu_torch.models import demix as t_demix
from pyfasst_tpu_torch.tf.filterbank import spectral_basis

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["erb", "mel"])
@pytest.mark.parametrize("n_bands,F,fs,wlen", [(32, 513, 16000, 1024),
                                               (24, 65, 16000, 128),
                                               (40, 129, 44100, 256)])
def test_spectral_basis_matches_jax(kind, n_bands, F, fs, wlen):
    got = spectral_basis(kind, n_bands, F, fs, wlen)
    want = j_spectral_basis(kind, n_bands, F, fs, wlen)
    assert got.shape == (F, n_bands)
    np.testing.assert_array_equal(got, want)
    # every frequency row is covered (the shelves at both ends)
    assert np.all(got.sum(axis=1) > 0)


def test_spectral_basis_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown filterbank"):
        spectral_basis("bark", 8, 33, 16000, 64)


def _anechoic(F, g, d):
    f = np.arange(F)
    return np.stack([np.ones(F), g * np.exp(-1j * np.pi * f * d / (F - 1))],
                    axis=1)


def _plane(rng, F=65, N=96, gains=(0.4, 1.0, 2.0), delays=(-3.0, 0.5, 2.5),
           bands=((2, 14), (20, 34), (42, 60))):
    """The small anechoic mixture of tests/test_configs.py (configs[1])."""
    X = 0
    for g, d, (lo, hi) in zip(gains, delays, bands):
        s = np.zeros((F, N), complex)
        s[lo:hi] = (rng.standard_normal((hi - lo, N))
                    + 1j * rng.standard_normal((hi - lo, N)))
        X = X + _anechoic(F, g, d)[:, None, :] * s[..., None]
    return X


def test_demix_on_a_plane_matches_jax(rng):
    X = _plane(rng)
    got, want = t_demix.DEMIX(X=X), j_demix.DEMIX(X=X)
    g, d = got.comp_parameters(3)
    gj, dj = want.comp_parameters(3)
    np.testing.assert_array_equal(g, gj)
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(got.mixing(65), want.mixing(65))
    assert got.mixing(65).shape == (3, 65, 2, 1)
    z, w = got._features()
    zs = z / got._cluster_scale
    np.testing.assert_array_equal(
        t_demix._weighted_kmeans(zs, w, 3)[1],
        j_demix._weighted_kmeans(zs, w, 3)[1])
    assert got.estimate_count(K_max=4) == want.estimate_count(K_max=4) == 3


def _anechoic_audio(rng, fs=16000, seconds=1.0):
    """Three band-limited noises, integer delays: the anechoic recipe of
    tools/validate_hw.py at a short length."""
    from scipy.signal import butter, lfilter
    n = int(fs * seconds)
    imgs = []
    for (lo, hi), g, d in zip([(0.01, 0.2), (0.15, 0.55), (0.45, 0.95)],
                              [0.5, 1.0, 1.8], [-4, 0, 5]):
        b, a = butter(4, [lo, hi], btype="band")
        s = lfilter(b, a, rng.standard_normal(n))
        s = s / np.std(s)
        imgs.append(np.stack([s, g * np.roll(s, d)], 1))
    mix = np.sum(imgs, axis=0)
    return (0.9 * mix / np.max(np.abs(mix))).astype(np.float32)


def test_demix_from_audio_matches_jax(rng, tmp_path):
    import scipy.io.wavfile
    mix = _anechoic_audio(rng)
    wav = str(tmp_path / "mix.wav")
    scipy.io.wavfile.write(wav, 16000, mix)
    got = t_demix.DEMIX(wav, wlen=512)
    want = j_demix.DEMIX(wav, wlen=512)
    assert np.max(np.abs(got.X - want.X)) < 1e-5 * np.max(np.abs(want.X))
    g, d = got.comp_parameters(3)
    gj, dj = want.comp_parameters(3)
    np.testing.assert_allclose(g, gj, rtol=1e-5)
    np.testing.assert_allclose(d, dj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.mixing(257), want.mixing(257), rtol=1e-5,
                               atol=1e-5)
    z, w = got._features()
    zj, wj = want._features()
    assert z.shape == zj.shape
    np.testing.assert_array_equal(
        t_demix._weighted_kmeans(z / got._cluster_scale, w, 3)[1],
        j_demix._weighted_kmeans(zj / want._cluster_scale, wj, 3)[1])
    # the recipe's integer delays and gains come back
    order = np.argsort(g)
    np.testing.assert_allclose(g[order], [0.5, 1.0, 1.8], rtol=0.1)
    assert np.max(np.abs(d[order] - np.array([-4, 0, 5]))) < 0.5
    # an array input is read as audio at `fs`
    arr = t_demix.DEMIX(mix, fs=16000, wlen=512)
    np.testing.assert_array_equal(arr.X, got.X)
