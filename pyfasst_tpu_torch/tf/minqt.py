"""Minimum-Q / constant-Q transform (log-frequency front-end).

Port of pyfasst_tpu/tf/minqt.py. The analysis is one full-float32 product
per channel of the signal's frames with a fixed complex kernel on a
log-frequency grid:

    X_cqt[k, n] = sum_t  w_k(t - n H) exp(-2 pi i f_k (t - n H)) x(t)
                = (frames @ K)[n, k],     K (wlen, K_bins) complex kernel

Synthesis uses the real least-squares dual (NumPy ``pinv`` with rcond 1e-3
on the host, as the JAX class computes it), weights each frame's
projection by a Hann taper and overlap-adds, normalized by the taper's own
overlap-add: a reconstruction of the band-limited projection.

Signals are (T,) or (T, I); coefficients (B, N) or (B, N, I).
invertTransform also takes leading axes: (..., B, N, I) -> (..., T, I).
Arrays go to `device` (the card unless the caller asks for "cpu");
tensors stay on their own device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyfasst_tpu_torch.tf.stft import _frame_geometry, _frames, _overlap_add
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyfasst_tpu_torch.utils.precision import highest_precision


def minqt_kernel(fs: int, wlen: int, n_bins: int, fmin: float, fmax: float,
                 Q: float = 17.0, min_bw_hz: Optional[float] = None
                 ) -> np.ndarray:
    """(wlen, n_bins) complex analysis kernel on a log-frequency grid.

    Q is capped so every atom's bandwidth is at least min_bw_hz (the
    'minimum-Q' behaviour: low frequencies would otherwise need unboundedly
    long windows).
    """
    min_bw_hz = min_bw_hz or 2.0 * fs / wlen
    freqs = np.geomspace(fmin, fmax, n_bins)
    t = np.arange(wlen) - wlen / 2
    K = np.zeros((wlen, n_bins), np.complex128)
    for k, fk in enumerate(freqs):
        bw = max(fk / Q, min_bw_hz)                 # Hz
        L = min(wlen, int(round(Q_eff_len(fs, bw))))
        win = np.zeros(wlen)
        h = np.hanning(L)
        start = (wlen - L) // 2
        win[start:start + L] = h / (h.sum() + 1e-12)
        K[:, k] = win * np.exp(-2j * np.pi * fk * t / fs)
    return K


def Q_eff_len(fs: int, bw_hz: float) -> float:
    """Hann main-lobe length (samples) for a target bandwidth."""
    return 4.0 * fs / bw_hz


class MinQTransfo:
    """Min-Q analysis/synthesis front-end (reference API:
    computeTransform / invertTransform)."""

    name = "minqt"

    def __init__(self, fs: int = 44100, wlen: int = 4096,
                 hop: Optional[int] = None, n_bins: int = 144,
                 fmin: float = 40.0, fmax: Optional[float] = None,
                 Q: float = 17.0, device=DEFAULT_DEVICE):
        self.fs = int(fs)
        self.wlen = int(wlen)
        self.hop = int(hop or wlen // 4)
        if self.wlen % self.hop != 0:
            raise ValueError(
                f"MinQTransfo requires hop dividing wlen (got wlen={wlen}, "
                f"hop={self.hop}): the framing/OLA use the reshape fast path")
        self.device = resolve_device(device)
        fmax = fmax or 0.45 * fs
        self.freqs = np.geomspace(fmin, fmax, n_bins)
        self.K = minqt_kernel(fs, wlen, n_bins, fmin, fmax, Q)   # (wlen, B)
        # real least-squares dual: solve min_f || K^T f - c || over REAL
        # frames by stacking real/imag parts; neighbouring log-frequency
        # atoms are highly correlated, so small singular values are cut
        # (else the dual amplifies float32 noise by 1e6+)
        M = np.concatenate([self.K.real.T, self.K.imag.T], axis=0)  # (2B, w)
        self.dual_real = np.linalg.pinv(M, rcond=1e-3)           # (wlen, 2B)
        self.F = n_bins
        self._nsamples: Optional[int] = None

    def _f32(self, a: np.ndarray, device) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    @highest_precision
    def computeTransform(self, data) -> torch.Tensor:
        """(nsamples[, I]) -> complex (B, N[, I]): one product per channel."""
        if isinstance(data, torch.Tensor):
            x = data.to(torch.float32)
        else:
            x = torch.as_tensor(np.asarray(data, np.float32),
                                device=self.device)
        self._nsamples = int(x.shape[0])
        frames = _frames(x, self.wlen, self.hop)       # ([I,] N, wlen)
        re = frames @ self._f32(self.K.real, x.device)
        im = frames @ self._f32(self.K.imag, x.device)
        X = torch.complex(re, im)                      # ([I,] N, B)
        return X.mT if x.ndim == 1 else X.permute(2, 1, 0)

    @highest_precision
    def invertTransform(self, Xb, nsamples: Optional[int] = None
                        ) -> torch.Tensor:
        """Real least-squares dual synthesis (band-limited projection)."""
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        if not isinstance(Xb, torch.Tensor):
            Xb = torch.as_tensor(np.asarray(Xb), device=self.device)
        dev = Xb.device
        # (B, N) -> (N, B); (..., B, N, I) -> (..., I, N, B)
        Xn = Xb.mT if Xb.ndim == 2 else Xb.permute(
            *range(Xb.ndim - 3), -1, -2, -3)
        c = torch.cat([Xn.real, Xn.imag], dim=-1)      # (..., N, 2B)
        frames = c @ self._f32(self.dual_real.T, dev)  # (..., N, wlen)
        pad_front, _, n_frames, padded_len = _frame_geometry(
            n, self.wlen, self.hop)
        # each frame's projection is accurate near the frame CENTER (the
        # atoms are Hann-windowed): weight contributions by a Hann taper
        # and normalize by the taper's own overlap-add
        taper = self._f32(np.hanning(self.wlen) + 1e-3, dev)
        y = _overlap_add(frames * taper, self.hop, padded_len)
        tsum = _overlap_add(taper[None].expand(n_frames, self.wlen),
                            self.hop, padded_len)
        y = (y / tsum)[..., pad_front:pad_front + n]
        return y if Xb.ndim == 2 else y.transpose(-1, -2)

    forward = computeTransform
    inverse = invertTransform
