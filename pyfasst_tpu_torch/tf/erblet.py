"""Perfect-reconstruction ERBlet transform (uniform hop, static shapes).

Port of pyfasst_tpu/tf/erblet.py. Every band is sampled at the same rate
N, chosen so the widest band still satisfies the painless condition
(support <= N DFT bins); the coefficients form one dense (B, N) plane per
channel and the dual is exact and closed-form:

    analysis:  C_b = fold_N( rfft(x) * W_b ),    c_b = ifft_N(C_b)
    synthesis: X^[k] = sum_b unfold_b( fft_N(c_b) )[k] * W_b[k] / S[k],
               S[k] = sum_b W_b[k]^2,            x = irfft(X^)

The geometry (band edges, N, the padded length Tp, the windows W and the
dual windows Wd) is the JAX package's, computed on the host with NumPy by
the same code, including its FFT-friendly rounding of N and Tp. cuFFT
takes any length, but identical (N, Tp) is what makes the two packages'
coefficient planes comparable bin for bin.

The JAX analysis is a scatter-add whose clamped entries (past a band's
support) add zeros onto a valid bin. Here the host keeps only the valid
(band, m, k) entries, which hit distinct targets (a band's support is a
contiguous run of at most N bins, so k -> k mod N is one to one), and the
analysis writes them with one ``index_put_`` without accumulation. The
synthesis sums overlapping bands into each rfft bin as a gather in a fixed
order: for each bin, its at most c covering (band, m) pairs, padded with
weight 0, added in band order. No float atomics, so the result is the
same from run to run.

`MultiRateERBLet` groups bands into power-of-two decimation groups, each
one dense (B_g, N_g) plane, as the JAX class does.

Signals are (T,) or (T, I); coefficients (B, N) or (B, N, I).
invertTransform also takes leading axes: (..., B, N, I) -> (..., T, I).
Arrays go to `device` (the card unless the caller asks for "cpu");
tensors stay on their own device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pyfasst_tpu_torch.tf.filterbank import erb_to_hz, hz_to_erb
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# FFT lengths the JAX package rounds to (its TPU backend compiles rfft at
# f * 2^k for these f); kept so both packages share one geometry
_FFT_FRIENDLY_ODD = (1, 3, 5, 9, 15)


def _fft_friendly(n: int) -> int:
    """Smallest m >= n of the form f * 2^k with f in _FFT_FRIENDLY_ODD."""
    n = max(int(n), 1)
    best = None
    for f in _FFT_FRIENDLY_ODD:
        m = f
        while m < n:
            m *= 2
        if best is None or m < best:
            best = m
    return best


def _band_window(f, lo_hz, c, hi_hz, first: bool, last: bool):
    """Hann-profile bump of one band at frequencies f (Hz); the first and
    last bands are shelves toward DC and Nyquist."""
    up = (f - lo_hz) / max(c - lo_hz, 1e-9)
    down = (hi_hz - f) / max(hi_hz - c, 1e-9)
    if first:
        up = np.ones_like(f)                        # DC shelf
    if last:
        down = np.ones_like(f)                      # Nyquist shelf
    r = np.clip(np.minimum(up, down), 0.0, 1.0)
    return np.sin(0.5 * np.pi * r) ** 2             # Hann profile


def _tables(idx, valid, rows, m, W, Wd, K: int) -> dict:
    """Host index tables of one dense plane (rows x N) over K rfft bins.

    Analysis: the valid (row, m, k) entries and their windows. Synthesis:
    for every bin k, its covering (row, m) pairs in row order, padded to
    the largest cover c with weight 0: cover_r, cover_m (c, K) and
    cover_w (c, K)."""
    r_v, j_v = np.nonzero(valid)                    # row-major: row order
    k_v = idx[r_v, j_v]
    order = np.argsort(k_v, kind="stable")          # by bin, rows in order
    k_s = k_v[order]
    counts = np.bincount(k_s, minlength=K)
    c = max(int(counts.max()), 1)
    slot = np.arange(k_s.size) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    cover_r = np.zeros((c, K), np.int64)
    cover_m = np.zeros((c, K), np.int64)
    cover_w = np.zeros((c, K), np.float32)
    cover_r[slot, k_s] = rows[r_v[order]]
    cover_m[slot, k_s] = m[r_v, j_v][order]
    cover_w[slot, k_s] = Wd[r_v, j_v][order]
    return dict(a_r=rows[r_v], a_m=m[r_v, j_v], a_k=k_v,
                a_w=W[r_v, j_v].astype(np.float32),
                cover_r=cover_r, cover_m=cover_m, cover_w=cover_w)


def _on(tables: dict, device) -> dict:
    """The tables as tensors on `device`, cached in the tables dict."""
    key = ("tensors", str(device))
    if key not in tables:
        tables[key] = {n: torch.as_tensor(a, device=device)
                       for n, a in tables.items() if isinstance(a, np.ndarray)}
    return tables[key]


def _signal(data, device) -> torch.Tensor:
    """A float32 signal tensor: a tensor stays on its device, an array goes
    to `device`."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.float32)
    return torch.as_tensor(np.asarray(data, np.float32), device=device)


def _analysis(X: torch.Tensor, t: dict, shape) -> torch.Tensor:
    """One plane's folded coefficients: X (K[, I]) rfft of the signal ->
    (rows, N[, I]) with every valid entry written once."""
    w = t["a_w"] if X.ndim == 1 else t["a_w"][:, None]
    C = X.new_zeros(shape)
    C[t["a_r"], t["a_m"]] = X[t["a_k"]] * w
    return C


def _synthesis(C: torch.Tensor, t: dict) -> torch.Tensor:
    """One plane's unfolded, dual-weighted contribution to every rfft bin:
    C (..., rows, N, I) spectra of the coefficients -> (..., K, I), each
    bin's covering pairs added in row order."""
    X = None
    for c in range(t["cover_r"].shape[0]):
        v = C[..., t["cover_r"][c], t["cover_m"][c], :] \
            * t["cover_w"][c][:, None]
        X = v if X is None else X + v
    return X


def _coefficients(Cb, device) -> Tuple[torch.Tensor, bool]:
    """Coefficients as a complex tensor (..., B, N, I); True when a channel
    axis was added to a (B, N) input."""
    if not isinstance(Cb, torch.Tensor):
        Cb = torch.as_tensor(np.asarray(Cb), device=device)
    if Cb.ndim == 2:
        return Cb[..., None], True
    return Cb, False


class ERBLetTransform:
    """Invertible ERB-scale transform: computeTransform / invertTransform.

    Parameters
    ----------
    fs : sample rate.
    n_bands : number of ERB-spaced bands covering [0, fs/2].
    hop : subband sample period in signal samples; None picks the largest
        hop that keeps the painless condition (widest band support <= N)
        with a safety factor of 2 for typical signal lengths.
    fmin : lowest band center (Hz); below it the first band is a shelf.
    scale : 'erb' (auditory spacing) or 'log' (geometric spacing = a
        perfect-reconstruction constant-Q transform).
    device : where array inputs go (the card unless "cpu").
    """

    name = "erblet"

    def __init__(self, fs: int = 44100, n_bands: int = 64,
                 hop: Optional[int] = None, fmin: float = 50.0,
                 scale: str = "erb", device=DEFAULT_DEVICE):
        self.fs = int(fs)
        self.n_bands = int(n_bands)
        self.fmin = float(fmin)
        self.scale = scale
        self.device = resolve_device(device)
        if scale == "erb":
            e_lo, e_hi = hz_to_erb(fmin), hz_to_erb(fs / 2)
            interior = erb_to_hz(np.linspace(e_lo, e_hi, n_bands - 1))
        elif scale == "log":
            interior = np.geomspace(fmin, fs / 2, n_bands - 1)
        else:
            raise ValueError(f"scale must be 'erb' or 'log', got {scale!r}")
        self.centers_hz = np.concatenate([[0.0], interior])
        self.centers_hz[-1] = fs / 2
        if hop is None:
            # widest band: last interior band, half-width = center gap
            max_bw_hz = 2.0 * (self.centers_hz[-1] - self.centers_hz[-2])
            hop = max(int(self.fs / (2.0 * max_bw_hz)), 1)
        self.hop = int(hop)
        self._cache: dict = {}
        self._nsamples: Optional[int] = None

    def _edges(self, Tp: int):
        """Band edges in Hz and in rfft bins of a Tp-point transform."""
        K = Tp // 2 + 1
        df = self.fs / Tp
        c = self.centers_hz
        lo_hz = np.concatenate([[0.0], c[:-1]])
        hi_hz = np.concatenate([c[1:], [self.fs / 2]])
        lo = np.floor(lo_hz / df).astype(np.int64)
        hi = np.minimum(np.ceil(hi_hz / df).astype(np.int64) + 1, K)
        return K, df, lo_hz, hi_hz, lo, hi

    # -- geometry (host, cached per padded length) ---------------------------
    def _geometry(self, T: int) -> dict:
        # perfect reconstruction needs only Tp >= T (zero padding) and
        # every band support <= N (fold injectivity)
        N = _fft_friendly(-(-T // self.hop))  # subband samples (frames)
        Tp = _fft_friendly(N * self.hop)
        key = (Tp, N)
        if key in self._cache:
            return self._cache[key]
        K, df, lo_hz, hi_hz, lo, hi = self._edges(Tp)
        c = self.centers_hz
        B = self.n_bands
        Lmax = int((hi - lo).max())
        if Lmax > N:
            raise ValueError(
                f"hop={self.hop} too large for perfect reconstruction: "
                f"widest band needs {Lmax} bins > N={N} subband samples; "
                f"use hop <= {self.hop * N // Lmax}")
        j = np.arange(Lmax)
        idx = lo[:, None] + j[None, :]                     # (B, Lmax)
        valid = idx < hi[:, None]
        idx = np.minimum(idx, K - 1)
        freqs = idx * df
        W = np.zeros((B, Lmax))
        for b in range(B):
            W[b] = _band_window(freqs[b], lo_hz[b], c[b], hi_hz[b],
                                b == 0, b == B - 1)
        W *= valid
        # diagonal frame operator S[k] = sum_b W_b[k]^2 over the full grid
        S = np.zeros(K)
        np.add.at(S, idx.ravel(), (W ** 2).ravel())
        if not S.min() > 1e-6:
            raise ValueError("ERBlet coverage hole (frame not invertible)")
        Wd = W / S[np.minimum(idx, K - 1)]                  # dual windows
        W32, Wd32 = W.astype(np.float32), Wd.astype(np.float32)
        geo = dict(N=N, Tp=Tp, K=K, idx=idx, m=idx % N, W=W32, Wd=Wd32,
                   tables=_tables(idx, valid, np.arange(B), idx % N, W32,
                                  Wd32, K))
        self._cache[key] = geo
        return geo

    # -- transform -----------------------------------------------------------
    def computeTransform(self, data) -> torch.Tensor:
        """(T[, I]) real -> complex subband coefficients (B, N[, I])."""
        x = _signal(data, self.device)
        T = int(x.shape[0])
        self._nsamples = T
        g = self._geometry(T)
        X = torch.fft.rfft(x, n=g["Tp"], dim=0)            # (K[, I])
        C = _analysis(X, _on(g["tables"], x.device),
                      (self.n_bands, g["N"]) + tuple(x.shape[1:]))
        return torch.fft.ifft(C, dim=1)                    # (B, N[, I])

    def invertTransform(self, Cb, nsamples: Optional[int] = None
                        ) -> torch.Tensor:
        """Exact dual synthesis: (..., B, N[, I]) -> (..., nsamples[, I])."""
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        Cb, squeeze = _coefficients(Cb, self.device)
        g = self._geometry(n)
        X = _synthesis(torch.fft.fft(Cb, dim=-2),
                       _on(g["tables"], Cb.device))       # (..., K, I)
        y = torch.fft.irfft(X, n=g["Tp"], dim=-2)[..., :n, :]
        return y[..., 0] if squeeze else y

    forward = computeTransform
    inverse = invertTransform

    # -- conveniences --------------------------------------------------------
    def band_centers(self) -> np.ndarray:
        """Band center frequencies in Hz, (n_bands,)."""
        return self.centers_hz.copy()

    def frame_bounds(self, T: int) -> Tuple[float, float]:
        """(A, B) frame bounds of the analysis system for length T: the
        least and largest S[k]. Ratio B/A near 1 means a snug frame."""
        g = self._geometry(T)
        S = np.zeros(g["K"])
        np.add.at(S, g["idx"].ravel(), (g["W"] ** 2).ravel())
        return float(S.min()), float(S.max())


class MultiRateERBLet(ERBLetTransform):
    """Per-band-rate ERBlet: bands grouped into power-of-two decimation
    groups (group g holds every band whose support fits N0 / 2**g aliasing
    bins), each group one dense (B_g, N_g) coefficient plane. The global
    diagonal dual W / S (S summed over all groups) finishes exact perfect
    reconstruction, as in ERBLetTransform.

    computeTransform returns a list of (B_g, N_g[, I]) complex tensors
    (empty groups omitted); `group_bands` maps each row back to its band.
    invertTransform consumes that list.
    """

    name = "erblet_multirate"

    def __init__(self, *args, max_decimation: int = 64, **kw):
        super().__init__(*args, **kw)
        g = int(max_decimation)
        if g < 1 or (g & (g - 1)):
            raise ValueError("max_decimation must be a power of two")
        self.max_decimation = g

    def _geometry(self, T: int) -> dict:
        N0 = -(-T // self.hop)
        Gmax = self.max_decimation
        while Gmax > 1 and N0 < 2 * Gmax:      # keep at least 2 rows/group
            Gmax //= 2
        # N0 a friendly multiple of every rate; Tp rounds independently
        N0 = _fft_friendly(-(-N0 // Gmax)) * Gmax
        Tp = _fft_friendly(N0 * self.hop)
        key = (Tp, N0)
        if key in self._cache:
            return self._cache[key]
        K, df, lo_hz, hi_hz, lo, hi = self._edges(Tp)
        c = self.centers_hz
        B = self.n_bands
        L = hi - lo
        if int(L.max()) > N0:
            raise ValueError(
                f"hop={self.hop} too large for perfect reconstruction: "
                f"widest band needs {int(L.max())} bins > N={N0}")
        # per-band decimation: largest power of two d <= Gmax with
        # N0 / d >= L_b  (support still fits the aliasing modulus)
        dec = np.minimum(Gmax, 2 ** np.floor(np.log2(
            np.maximum(N0 / np.maximum(L, 1), 1.0))).astype(np.int64))
        # global dual normalization over ALL bands (grouping-independent)
        S = np.zeros(K)
        Wfull = []
        for b in range(B):
            f = (lo[b] + np.arange(L[b])) * df
            w = _band_window(f, lo_hz[b], c[b], hi_hz[b], b == 0, b == B - 1)
            Wfull.append(w)
            S[lo[b]:hi[b]] += w ** 2
        if not S.min() > 1e-6:
            raise ValueError("ERBlet coverage hole (frame not invertible)")
        groups = []
        for d in sorted(set(int(x) for x in dec)):
            bands = np.nonzero(dec == d)[0]
            Ng = N0 // d
            Lg = int(L[bands].max())
            j = np.arange(Lg)
            idx = lo[bands][:, None] + j[None, :]
            valid = idx < hi[bands][:, None]
            idx = np.minimum(idx, K - 1)
            Wg = np.zeros((len(bands), Lg))
            Wdg = np.zeros((len(bands), Lg))
            for r_, b in enumerate(bands):
                Wg[r_, :L[b]] = Wfull[b]
                Wdg[r_, :L[b]] = Wfull[b] / S[lo[b]:hi[b]]
            Wg *= valid
            Wdg *= valid
            W32, Wd32 = Wg.astype(np.float32), Wdg.astype(np.float32)
            groups.append(dict(
                d=d, N=Ng, bands_np=bands, idx=idx, m=idx % Ng, W=W32,
                Wd=Wd32, tables=_tables(idx, valid, np.arange(len(bands)),
                                        idx % Ng, W32, Wd32, K)))
        geo = dict(N0=N0, Tp=Tp, K=K, groups=groups)
        self._cache[key] = geo
        return geo

    @property
    def group_bands(self):
        """List of band-index arrays, one per coefficient plane (after a
        computeTransform; geometry of the longest length seen)."""
        if not self._cache:
            raise ValueError("call computeTransform first")
        geo = self._cache[max(self._cache)]
        return [g["bands_np"] for g in geo["groups"]]

    def computeTransform(self, data):
        """(T[, I]) real -> [ (B_g, N_g[, I]) complex ] per rate group."""
        x = _signal(data, self.device)
        T = int(x.shape[0])
        self._nsamples = T
        geo = self._geometry(T)
        X = torch.fft.rfft(x, n=geo["Tp"], dim=0)
        out = []
        for g in geo["groups"]:
            C = _analysis(X, _on(g["tables"], x.device),
                          (len(g["bands_np"]), g["N"]) + tuple(x.shape[1:]))
            out.append(torch.fft.ifft(C, dim=1) / g["d"])
        return out

    def invertTransform(self, Cs, nsamples: Optional[int] = None):
        """Exact dual synthesis from the rate-group list."""
        n = nsamples if nsamples is not None else self._nsamples
        if n is None:
            raise ValueError("call computeTransform first or pass nsamples")
        geo = self._geometry(n)
        X = None
        for g, Cb in zip(geo["groups"], Cs):
            Cb, squeeze = _coefficients(Cb, self.device)
            acc = _synthesis(torch.fft.fft(Cb * g["d"], dim=-2),
                             _on(g["tables"], Cb.device))
            X = acc if X is None else X + acc
        y = torch.fft.irfft(X, n=geo["Tp"], dim=-2)[..., :n, :]
        return y[..., 0] if squeeze else y

    forward = computeTransform
    inverse = invertTransform

    def redundancy(self, T: int) -> float:
        """Total coefficients / uniform-hop coefficients for length T
        (< 1 = saving; the uniform version is B * N0)."""
        geo = self._geometry(T)
        total = sum(len(g["bands_np"]) * g["N"] for g in geo["groups"])
        return total / float(self.n_bands * geo["N0"])
