"""pyfasst_tpu_torch.tf.stft against pyfasst_tpu.tf.stft.

Spectra: float32 on both sides, compared at 2e-6 of the spectrum's peak
(the two FFT libraries sum the wlen taps in different orders; float32
rounding over log2(wlen) butterfly stages stays near 1e-6 of the peak).
Perfect reconstruction: relative error below 1e-6, the JAX suite's bar
(tests/test_stft.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.tf.stft import _istft_core as j_istft
from pyfasst_tpu.tf.stft import _stft_core as j_stft
from pyfasst_tpu_torch.tf import STFT, istft, stft
from pyfasst_tpu_torch.tf.stft import _istft_core, _stft_core, sine_window

torch.set_num_threads(1)

FS = 44100


def _clip(seed, n=FS // 2, channels=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, channels)).astype(np.float32)


def _win(wlen):
    return sine_window(wlen).astype(np.float32)


@pytest.mark.parametrize("wlen,hop", [(1024, 512), (256, 64), (256, 96)])
def test_stft_matches_jax(wlen, hop):
    x = _clip(0)
    want = np.asarray(j_stft(jnp.asarray(x), jnp.asarray(_win(wlen)), wlen,
                             hop, "fft"))
    got = _stft_core(torch.as_tensor(x), torch.as_tensor(_win(wlen)), wlen,
                     hop).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("wlen,hop", [(1024, 512), (256, 96)])
def test_istft_matches_jax(wlen, hop):
    n = FS // 2
    x = _clip(1, n)
    X = np.array(j_stft(jnp.asarray(x), jnp.asarray(_win(wlen)), wlen, hop,
                         "fft"))
    want = np.asarray(j_istft(jnp.asarray(X), jnp.asarray(_win(wlen)), wlen,
                              hop, n))
    got = _istft_core(torch.as_tensor(X), torch.as_tensor(_win(wlen)), wlen,
                      hop, n).numpy()
    assert got.shape == want.shape == (n, 2)
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("wlen,hop", [(1024, 512), (256, 128), (256, 64),
                                      (256, 96)])
@pytest.mark.parametrize("channels", [1, 2])
def test_perfect_reconstruction(wlen, hop, channels):
    n = FS // 2
    x = _clip(2, n, channels)
    x = x[:, 0] if channels == 1 else x
    X = stft(x, wlen=wlen, hop=hop, device="cpu")
    y = istft(X, nsamples=n, wlen=wlen, hop=hop).numpy()
    assert X.dtype == torch.complex64
    rel = np.linalg.norm(y - x) / np.linalg.norm(x)
    assert rel < 1e-6, rel


def test_clip_axis_matches_single_clips():
    """(B, T, I) signals give (B, F, N, I) spectra, clip by clip the same."""
    wlen, hop = 1024, 512
    xs = np.stack([_clip(s) for s in range(3)])
    win = torch.as_tensor(_win(wlen))
    Xb = _stft_core(torch.as_tensor(xs), win, wlen, hop)
    for b in range(3):
        Xs = _stft_core(torch.as_tensor(xs[b]), win, wlen, hop)
        assert torch.equal(Xb[b], Xs)
    yb = _istft_core(Xb, win, wlen, hop, xs.shape[1])
    assert yb.shape == xs.shape
    assert float((yb - torch.as_tensor(xs)).abs().max()) < 1e-5


def test_object_api_shapes():
    n = FS
    x = _clip(3, n)
    tr = STFT(wlen=1024, hop=512, fs=FS, device="cpu")
    X = tr.computeTransform(x)
    assert X.shape == (513, tr.n_frames(n), 2)
    y = tr.invertTransform(X).numpy()
    assert y.shape == (n, 2)
    assert np.linalg.norm(y - x) / np.linalg.norm(x) < 1e-6
    # the "matmul" method gives the "fft" method's spectra
    Xm = STFT(wlen=1024, hop=512, fs=FS, method="matmul",
              device="cpu").computeTransform(x)
    assert float((Xm - X).abs().max()) < 2e-6 * float(X.abs().max())
    with pytest.raises(ValueError, match="method"):
        stft(x, wlen=256, method="dft", device="cpu")


def test_array_input_defaults_to_card(monkeypatch):
    """An array given to stft/istft goes to the card unless the caller asks
    for the CPU: without a card the call raises, it never returns a CPU
    tensor; a tensor keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _clip(4, 2048)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stft(x, wlen=256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stft(x, wlen=256, device="cuda")
    X = stft(x, wlen=256, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        istft(X.numpy(), nsamples=2048, wlen=256)
    assert stft(torch.as_tensor(x), wlen=256).device.type == "cpu"
    assert istft(X, nsamples=2048, wlen=256).device.type == "cpu"
