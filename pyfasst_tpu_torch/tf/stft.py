"""STFT / inverse STFT with weighted overlap-add (WOLA).

Port of pyfasst_tpu/tf/stft.py (block streaming is not ported yet).
Framing is ``Tensor.unfold``. The "fft" method (the default) takes a batched
rfft of the frames; the "matmul" method two real full-float32 products with
the DFT's cosine and sine matrices, as the JAX package's GEMM-native path
does (a parity target, not a fast path: cuFFT is the fast one). Synthesis
is an overlap-add of shifted dense adds.

Reconstruction is exact (not just COLA-approximate): the inverse divides by
the per-sample window-energy sum sum_k w^2[t - k*hop], so any window/hop
with full coverage reconstructs to float precision when the spectrum is
unmodified.

Conventions: signals are (nsamples,) or (..., nsamples, I); spectra are
(F, N) or (..., F, N, I) complex with F = wlen//2 + 1 and N the frame count.
Leading axes (the clip axis B) pass through.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyfasst_tpu_torch.utils.precision import highest_precision


def sine_window(wlen: int, dtype=np.float64) -> np.ndarray:
    """Periodic sine window (sqrt-Hann); the reference's 'sinebell'."""
    return np.sin(np.pi * (np.arange(wlen, dtype=dtype) + 0.5) / wlen)


def _frame_geometry(nsamples: int, wlen: int, hop: int):
    """Padding and frame count so every input sample is window-interior."""
    pad_front = wlen - hop
    cover = nsamples + 2 * (wlen - hop)
    n_frames = max(1, int(np.ceil(max(cover - wlen, 0) / hop)) + 1)
    padded_len = (n_frames - 1) * hop + wlen
    pad_back = padded_len - nsamples - pad_front
    return pad_front, pad_back, n_frames, padded_len


def _overlap_add(frames: torch.Tensor, hop: int, padded_len: int):
    """Overlap-add of frames (..., N, wlen) into (..., padded_len).

    For integer overlap factors k = wlen // hop it is k shifted dense adds
    in a fixed order; otherwise an index_add over the frame positions.
    """
    lead = frames.shape[:-2]
    n_frames, wlen = frames.shape[-2:]
    if wlen % hop == 0:
        k = wlen // hop
        out = None
        for i in range(k):
            chunk = frames[..., i * hop:(i + 1) * hop].reshape(
                lead + (n_frames * hop,))
            padded = torch.nn.functional.pad(
                chunk, (i * hop, (k - 1 - i) * hop))
            out = padded if out is None else out + padded
        return out
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop
           + torch.arange(wlen, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros(lead + (padded_len,))
    return out.index_add_(-1, idx, frames.reshape(lead + (-1,)))


def _ola_norm(window: torch.Tensor, n_frames: int, wlen: int, hop: int,
              padded_len: int) -> torch.Tensor:
    """Per-sample window-energy sum  sum_k w^2[t - k*hop]."""
    w2 = (window ** 2)[None, :].expand(n_frames, wlen)
    wsum = _overlap_add(w2, hop, padded_len)
    return torch.clamp(wsum, min=1e-12)


def _dft_matrices(wlen: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rfft matrices (float64) for the matmul path:
    X = frames @ (C - iS)."""
    f = np.arange(wlen // 2 + 1)
    t = np.arange(wlen)
    ang = 2.0 * np.pi * np.outer(t, f) / wlen
    return np.cos(ang), np.sin(ang)


def _frames(x: torch.Tensor, wlen: int, hop: int) -> torch.Tensor:
    """Unwindowed frames of a signal (nsamples,) or (..., nsamples, I),
    padded as _frame_geometry says: (N, wlen) or (..., I, N, wlen), time
    last (a view of the padded signal, the port's form of the JAX
    package's _frame_by_reshape)."""
    nsamples = x.shape[0] if x.ndim == 1 else x.shape[-2]
    pad_front, pad_back, _, _ = _frame_geometry(nsamples, wlen, hop)
    xt = x if x.ndim == 1 else x.transpose(-1, -2)       # time last
    xp = torch.nn.functional.pad(xt, (pad_front, pad_back))
    return xp.unfold(-1, wlen, hop)


@highest_precision
def _stft_core(x: torch.Tensor, window: torch.Tensor, wlen: int, hop: int,
               method: str = "fft") -> torch.Tensor:
    """(nsamples,) -> (F, N); (..., nsamples, I) -> (..., F, N, I)."""
    frames = _frames(x, wlen, hop) * window              # (..., N, wlen)
    if method == "matmul":
        C, S = (torch.as_tensor(m, dtype=x.dtype, device=x.device)
                for m in _dft_matrices(wlen))
        X = torch.complex(frames @ C, -(frames @ S))     # (..., N, F)
    elif method == "fft":
        X = torch.fft.rfft(frames, dim=-1)               # (..., N, F)
    else:
        raise ValueError(f"unknown STFT method {method!r}")
    if x.ndim == 1:
        return X.transpose(0, 1)                          # (F, N)
    return X.permute(*range(X.ndim - 3), -1, -2, -3)     # (..., F, N, I)


@highest_precision
def _istft_core(X: torch.Tensor, window: torch.Tensor, wlen: int, hop: int,
                nsamples: int) -> torch.Tensor:
    """(F, N) -> (nsamples,); (..., F, N, I) -> (..., nsamples, I)."""
    pad_front, _, n_frames, padded_len = _frame_geometry(nsamples, wlen, hop)
    got = X.shape[1] if X.ndim == 2 else X.shape[-2]
    if got != n_frames:
        raise ValueError(f"expected {n_frames} frames, got {got}")
    if X.ndim == 2:
        Xn = X.transpose(0, 1)                            # (N, F)
    else:
        Xn = X.permute(*range(X.ndim - 3), -1, -2, -3)    # (..., I, N, F)
    frames = torch.fft.irfft(Xn, n=wlen, dim=-1) * window
    y = _overlap_add(frames, hop, padded_len)             # (..., [I,] T)
    wsum = _ola_norm(window.to(frames.dtype), n_frames, wlen, hop,
                     padded_len)
    y = (y / wsum)[..., pad_front:pad_front + nsamples]
    return y if X.ndim == 2 else y.transpose(-1, -2)


def _window(window, wlen: int, dtype, device) -> torch.Tensor:
    w = window if window is not None else sine_window(wlen)
    return torch.as_tensor(np.asarray(w), dtype=dtype, device=device)


def stft(x, wlen: int = 1024, hop: Optional[int] = None,
         window: Optional[np.ndarray] = None, method: str = "fft",
         device=None) -> torch.Tensor:
    """Analysis: (nsamples[, I]) -> complex (F, N[, I]).

    x may be a tensor (it stays on its device) or an array, which goes to
    `device` (the CPU when None).
    """
    hop = hop or wlen // 2
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=device or "cpu")
    win = _window(window, wlen, x.dtype, x.device)
    return _stft_core(x, win, wlen, hop, method)


def istft(X, nsamples: int, wlen: int = 1024, hop: Optional[int] = None,
          window: Optional[np.ndarray] = None, device=None) -> torch.Tensor:
    """Synthesis: complex (F, N[, I]) -> (nsamples[, I]) via normalized WOLA."""
    hop = hop or wlen // 2
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.asarray(X), device=device or "cpu")
    win = _window(window, wlen, X.real.dtype, X.device)
    return _istft_core(X, win, wlen, hop, nsamples)


class STFT:
    """Object front-end matching the reference TFTransform API.

    ``computeTransform(data)`` / ``invertTransform(X)``. Frequency axis
    first. Arrays go to `device`, the card unless the caller asks for
    "cpu" (a "cuda" request without a card raises). Block streaming
    (``stream_blocks``) is not ported yet.
    """

    name = "stft"

    def __init__(self, wlen: int = 1024, hop: Optional[int] = None,
                 fs: int = 44100, method: str = "fft",
                 device=DEFAULT_DEVICE):
        self.wlen = int(wlen)
        self.hop = int(hop or wlen // 2)
        self.fs = int(fs)
        self.method = method
        self.device = resolve_device(device)
        self.window = sine_window(self.wlen)
        self.F = self.wlen // 2 + 1
        self._nsamples: Optional[int] = None

    @property
    def freqs(self) -> np.ndarray:
        return np.arange(self.F) * self.fs / self.wlen

    def n_frames(self, nsamples: int) -> int:
        return _frame_geometry(nsamples, self.wlen, self.hop)[2]

    def computeTransform(self, data):
        self._nsamples = int(data.shape[0])
        return stft(data, self.wlen, self.hop, self.window, self.method,
                    device=self.device)

    def invertTransform(self, X, nsamples: Optional[int] = None):
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        return istft(X, n, self.wlen, self.hop, self.window,
                     device=self.device)

    forward = computeTransform
    inverse = invertTransform
