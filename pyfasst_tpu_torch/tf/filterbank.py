"""ERB / Mel triangle filterbanks: fixed spectral bases and a front-end.

Port of pyfasst_tpu/tf/filterbank.py. The banks are NumPy and built on the
host once per model: ``spectral_basis`` hands one to the model as the fixed
FB factor (F x B) of each NMF component, with the free pattern weights FW
on the band grid. ``ERBTransform`` is an analysis/synthesis front-end over
the port's STFT: the bank and its least-squares dual (NumPy ``pinv`` on the
host, as the JAX class computes it) are applied as tensor products on the
spectra's device. ``MelBank`` applies a Mel bank to a power spectrogram.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyfasst_tpu_torch.tf.stft import STFT
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE
from pyfasst_tpu_torch.utils.precision import highest_precision


# -- frequency scales ---------------------------------------------------------

def hz_to_erb(f):
    """ERB-rate scale (Glasberg & Moore 1990)."""
    return 21.4 * np.log10(1.0 + 0.00437 * np.asarray(f, dtype=np.float64))


def erb_to_hz(e):
    return (10.0 ** (np.asarray(e, dtype=np.float64) / 21.4) - 1.0) / 0.00437


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _triangle_bank(freqs: np.ndarray, centers_hz: np.ndarray) -> np.ndarray:
    """Triangular filters on the given center grid; rows sum over all bands
    to ~1 everywhere: the first/last filters are shelves (flat outside
    their center), so frequencies below centers[1] and above centers[-2]
    are still covered.

    Full coverage is load-bearing: a fixed FB whose columns leave a
    frequency row at ~0 makes those bins unrepresentable by the model, and
    as the annealing noise floor shrinks their residual power drives the
    log-likelihood to -|x|^2/sigma."""
    B = len(centers_hz) - 2
    bank = np.zeros((B, len(freqs)), dtype=np.float64)
    for b in range(B):
        lo, c, hi = centers_hz[b], centers_hz[b + 1], centers_hz[b + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        if b == 0:
            up = np.ones_like(freqs, dtype=np.float64)      # low shelf
        if b == B - 1:
            down = np.ones_like(freqs, dtype=np.float64)    # high shelf
        bank[b] = np.clip(np.minimum(up, down), 0.0, None)
    return bank


def _bank_on_scale(n_bands: int, freqs: np.ndarray, fmin: float, fmax: float,
                   fwd, inv) -> np.ndarray:
    lo, hi = fwd(max(fmin, 1e-3)), fwd(fmax)
    centers = inv(np.linspace(lo, hi, n_bands + 2))
    return _triangle_bank(freqs, centers)


def erb_filterbank(n_bands: int, F: int, fs: int, wlen: int,
                   fmin: float = 20.0, fmax: Optional[float] = None) -> np.ndarray:
    """(B, F) triangular filterbank with ERB-spaced centers."""
    fmax = fmax or fs / 2
    freqs = np.arange(F) * fs / wlen
    return _bank_on_scale(n_bands, freqs, fmin, fmax, hz_to_erb, erb_to_hz)


def mel_filterbank(n_bands: int, F: int, fs: int, wlen: int,
                   fmin: float = 20.0, fmax: Optional[float] = None) -> np.ndarray:
    """(B, F) triangular filterbank with Mel-spaced centers."""
    fmax = fmax or fs / 2
    freqs = np.arange(F) * fs / wlen
    return _bank_on_scale(n_bands, freqs, fmin, fmax, hz_to_mel, mel_to_hz)


def spectral_basis(kind: str, n_bands: int, F: int, fs: int, wlen: int,
                   **kw) -> np.ndarray:
    """(F, B) fixed FB factor: column b is band b's smooth spectral blob.

    Columns are L1-normalized so free FW weights carry the scale.
    """
    if kind == "erb":
        bank = erb_filterbank(n_bands, F, fs, wlen, **kw)
    elif kind == "mel":
        bank = mel_filterbank(n_bands, F, fs, wlen, **kw)
    else:
        raise ValueError(f"unknown filterbank kind: {kind!r}")
    bank = bank / np.maximum(bank.sum(axis=1, keepdims=True), 1e-12)
    return bank.T.copy()  # (F, B)


@highest_precision
def _along_freq(M: np.ndarray, X: torch.Tensor) -> torch.Tensor:
    """The matrix M (G, F) applied along the frequency axis of spectra
    (F, N) or (..., F, N, I): (G, N) or (..., G, N, I), in X's dtype on X's
    device."""
    Mt = torch.as_tensor(M, dtype=X.dtype, device=X.device)
    if X.ndim == 2:
        return Mt @ X
    return torch.einsum("gf,...fni->...gni", Mt, X)


class MelBank:
    """Thin object wrapper over mel_filterbank (kept for API discovery):
    calling it applies the (B, F) bank to a power spectrogram (F, N[, I]),
    a tensor (on its device) or an array (on the host)."""

    def __init__(self, n_bands: int, F: int, fs: int, wlen: int, **kw):
        self.bank = mel_filterbank(n_bands, F, fs, wlen, **kw)

    def __call__(self, power_spec):
        if isinstance(power_spec, torch.Tensor):
            return _along_freq(self.bank, power_spec)
        return self.bank @ power_spec


class ERBTransform:
    """ERB-scale analysis front-end over the port's STFT.

    computeTransform / invertTransform, as the reference's transform
    objects. Analysis maps the STFT to B ERB bands through the filterbank;
    synthesis uses the least-squares dual (pinv), so invert(compute(x))
    reconstructs the band-limited projection. Spectra live on `device` (the
    card unless the caller asks for "cpu"); invertTransform also takes
    leading axes, (..., B, N, I).
    """

    name = "erb"

    def __init__(self, n_bands: int = 80, wlen: int = 1024,
                 hop: Optional[int] = None, fs: int = 44100,
                 fmin: float = 20.0, fmax: Optional[float] = None,
                 device=DEFAULT_DEVICE):
        self.stft = STFT(wlen=wlen, hop=hop, fs=fs, device=device)
        self.device = self.stft.device
        self.n_bands = int(n_bands)
        self.bank = erb_filterbank(n_bands, self.stft.F, fs, wlen,
                                   fmin=fmin, fmax=fmax)  # (B, F)
        self.dual = np.linalg.pinv(self.bank)             # (F, B)
        self.F = self.n_bands

    def computeTransform(self, data) -> torch.Tensor:
        """(T[, I]) -> complex (B, N[, I])."""
        return _along_freq(self.bank, self.stft.computeTransform(data))

    def invertTransform(self, Xb, nsamples: Optional[int] = None):
        if not isinstance(Xb, torch.Tensor):
            Xb = torch.as_tensor(np.asarray(Xb), device=self.device)
        return self.stft.invertTransform(_along_freq(self.dual, Xb),
                                         nsamples)

    forward = computeTransform
    inverse = invertTransform
