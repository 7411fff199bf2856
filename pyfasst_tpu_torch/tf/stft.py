"""STFT / inverse STFT with weighted overlap-add (WOLA).

Port of pyfasst_tpu/tf/stft.py. Framing is ``Tensor.unfold``. The "fft" method (the default) takes a batched
rfft of the frames; the "matmul" method two real full-float32 products with
the DFT's cosine and sine matrices, as the JAX package's GEMM-native path
does (a parity target, not a fast path: cuFFT is the fast one). Synthesis
is an overlap-add of shifted dense adds.

Streaming (the bounded-memory front-end of models/streaming.py):
``STFT.stream_blocks`` reads a WAV file a block of frames at a time and
transforms each block through the same framing core as the whole-signal
transform, so the blocks are bit-identical to slices of
``computeTransform``; ``StreamingSynthesis`` inverts block by block with a
``wlen - hop`` overlap carry.

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

from pyfasst_tpu_torch.audio import wav_info, wavread_block
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyfasst_tpu_torch.utils.logging import span
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


def _pad_signal(x: torch.Tensor, wlen: int, hop: int) -> torch.Tensor:
    """The signal (nsamples,) or (..., nsamples, I) padded as
    _frame_geometry says."""
    nsamples = x.shape[0] if x.ndim == 1 else x.shape[-2]
    pad_front, pad_back, _, _ = _frame_geometry(nsamples, wlen, hop)
    pad = (pad_front, pad_back) if x.ndim == 1 else (0, 0, pad_front,
                                                    pad_back)
    return torch.nn.functional.pad(x, pad)


def _unfold(xp: torch.Tensor, wlen: int, hop: int) -> torch.Tensor:
    """Unwindowed frames of a pre-padded signal (L,) or (..., L, I): (N,
    wlen) or (..., I, N, wlen), time last (a view of the signal, the port's
    form of the JAX package's _frame_by_reshape). The time-last signal is
    made contiguous first: the FFT's bits depend on its input's layout."""
    xt = xp if xp.ndim == 1 else xp.transpose(-1, -2).contiguous()
    return xt.unfold(-1, wlen, hop)


def _frames(x: torch.Tensor, wlen: int, hop: int) -> torch.Tensor:
    """Unwindowed frames of a signal (nsamples,) or (..., nsamples, I),
    padded as _frame_geometry says: (N, wlen) or (..., I, N, wlen)."""
    return _unfold(_pad_signal(x, wlen, hop), wlen, hop)


@highest_precision
def _spec_from_padded(xp: torch.Tensor, window: torch.Tensor, wlen: int,
                      hop: int, method: str = "fft") -> torch.Tensor:
    """Windowed spectra of a pre-padded signal (L,) or (..., L, I) with
    L = (N - 1) * hop + wlen: (F, N) or (..., F, N, I). Shared by the
    whole-signal transform and the block stream, so the two give the same
    bits."""
    frames = _unfold(xp, wlen, hop) * window             # (..., N, wlen)
    if method == "matmul":
        C, S = (torch.as_tensor(m, dtype=xp.dtype, device=xp.device)
                for m in _dft_matrices(wlen))
        X = torch.complex(frames @ C, -(frames @ S))     # (..., N, F)
    elif method == "fft":
        X = torch.fft.rfft(frames, dim=-1)               # (..., N, F)
    else:
        raise ValueError(f"unknown STFT method {method!r}")
    if xp.ndim == 1:
        return X.transpose(0, 1)                          # (F, N)
    return X.permute(*range(X.ndim - 3), -1, -2, -3)     # (..., F, N, I)


@span("stft")
def _stft_core(x: torch.Tensor, window: torch.Tensor, wlen: int, hop: int,
               method: str = "fft") -> torch.Tensor:
    """(nsamples,) -> (F, N); (..., nsamples, I) -> (..., F, N, I)."""
    return _spec_from_padded(_pad_signal(x, wlen, hop), window, wlen, hop,
                             method)


@span("istft")
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


def _array_device(device) -> torch.device:
    """Where an array given to stft/istft goes: `device`, the card when
    None."""
    return resolve_device(DEFAULT_DEVICE if device is None else device)


def stft(x, wlen: int = 1024, hop: Optional[int] = None,
         window: Optional[np.ndarray] = None, method: str = "fft",
         device=None) -> torch.Tensor:
    """Analysis: (nsamples[, I]) -> complex (F, N[, I]).

    x may be a tensor (it stays on its device) or an array, which goes to
    `device`: the card unless the caller asks for "cpu" (without a card a
    None or "cuda" device raises).
    """
    hop = hop or wlen // 2
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=_array_device(device))
    win = _window(window, wlen, x.dtype, x.device)
    return _stft_core(x, win, wlen, hop, method)


def istft(X, nsamples: int, wlen: int = 1024, hop: Optional[int] = None,
          window: Optional[np.ndarray] = None, device=None) -> torch.Tensor:
    """Synthesis: complex (F, N[, I]) -> (nsamples[, I]) via normalized WOLA.

    X may be a tensor (it stays on its device) or an array, which goes to
    `device`, as in stft."""
    hop = hop or wlen // 2
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.asarray(X), device=_array_device(device))
    win = _window(window, wlen, X.real.dtype, X.device)
    return _istft_core(X, win, wlen, hop, nsamples)


@highest_precision
def _synth_block_core(Xb: torch.Tensor, window: torch.Tensor,
                      carry_y: torch.Tensor, carry_w: torch.Tensor,
                      wlen: int, hop: int):
    """One streaming-synthesis block.

    Xb (F, Nb[, I]) complex spectra; carry_y ([I,] wlen - hop) and carry_w
    (wlen - hop,) the unfinished overlap-add tails of the previous push,
    time last. Returns (emitted_y, emitted_wsum, new_carry_y, new_carry_w),
    time last, where the emitted region (Nb * hop samples) is complete:
    every frame that overlaps it has been pushed (frames arrive in time
    order; a sample at local offset p < Nb * hop is covered only by frames
    i * hop <= p < i * hop + wlen, all inside this block or the carry)."""
    nb = Xb.shape[1]
    Xn = Xb.transpose(0, 1) if Xb.ndim == 2 else Xb.permute(2, 1, 0)
    frames = torch.fft.irfft(Xn, n=wlen, dim=-1) * window  # ([I,] Nb, wlen)
    L = (nb - 1) * hop + wlen
    y = _overlap_add(frames, hop, L)                       # ([I,] L)
    w = _overlap_add((window ** 2).to(frames.dtype)[None].expand(nb, wlen),
                     hop, L)                               # (L,)
    cl = wlen - hop
    y = torch.cat([y[..., :cl] + carry_y, y[..., cl:]], dim=-1)
    w = torch.cat([w[:cl] + carry_w, w[cl:]])
    emit = nb * hop
    return y[..., :emit], w[:emit], y[..., emit:], w[emit:]


class StreamingSynthesis:
    """Exact-WOLA inverse STFT, one block of frames at a time.

    The bounded-memory dual of ``STFT.stream_blocks``: push (F, Nb[, I])
    spectra blocks in time order; each ``push`` returns the newly
    completed time samples (WOLA-normalized) as a host float32 array,
    ``flush`` the final tail. The work runs on the device of the pushed
    blocks, and memory stays O(Nb): the full (F, N) plane never exists.
    Agrees with ``istft`` on the concatenated spectra to float rounding
    (the overlap-add order differs across block boundaries, so ~1e-6
    relative, not bit for bit). Requires wlen % hop == 0 (the default
    hop = wlen/2 qualifies).
    """

    def __init__(self, nsamples: int, wlen: int = 1024,
                 hop: Optional[int] = None,
                 window: Optional[np.ndarray] = None):
        self.wlen = int(wlen)
        self.hop = int(hop or wlen // 2)
        if self.wlen % self.hop:
            raise ValueError("StreamingSynthesis needs wlen % hop == 0")
        self._window_np = np.asarray(
            window if window is not None else sine_window(self.wlen))
        self.window = None               # on the blocks' device, at push
        pad_front, _, n_frames, _ = _frame_geometry(nsamples, self.wlen,
                                                    self.hop)
        self._skip = pad_front           # padded head samples to drop
        self._remaining = int(nsamples)  # output samples still to emit
        self.frames_expected = n_frames
        self._frames_seen = 0
        self._cy = None                  # carries allocated on first push
        self._cw = None

    def _emit(self, y: torch.Tensor, w: torch.Tensor) -> np.ndarray:
        """WOLA-normalize ([I,] m) samples, fetch them as (m[, I]) float32,
        drop the padded head and stop after nsamples."""
        y = y / torch.clamp(w, min=1e-12)
        y = (y if y.ndim == 1 else y.transpose(0, 1)).cpu().numpy()
        if self._skip:
            k = min(self._skip, y.shape[0])
            self._skip -= k
            y = y[k:]
        y = y[:max(self._remaining, 0)]
        self._remaining -= y.shape[0]
        return y

    def push(self, Xb) -> np.ndarray:
        """Consume one spectra block -> completed samples (m[, I]) f32."""
        if not isinstance(Xb, torch.Tensor):
            Xb = torch.as_tensor(np.asarray(Xb))
        cl = self.wlen - self.hop
        if self._cy is None:
            self.window = torch.as_tensor(self._window_np,
                                          dtype=torch.float32,
                                          device=Xb.device)
            lead = (Xb.shape[2],) if Xb.ndim == 3 else ()
            self._cy = torch.zeros(lead + (cl,), dtype=torch.float32,
                                   device=Xb.device)
            self._cw = torch.zeros((cl,), dtype=torch.float32,
                                   device=Xb.device)
        ey, ew, self._cy, self._cw = _synth_block_core(
            Xb, self.window, self._cy, self._cw, self.wlen, self.hop)
        self._frames_seen += Xb.shape[1]
        return self._emit(ey, ew)

    def flush(self) -> np.ndarray:
        """Emit the final (wlen - hop) overlap tail after the last push."""
        if self._cy is None:
            return np.zeros((0,), np.float32)
        if self._frames_seen != self.frames_expected:
            raise ValueError(
                f"expected {self.frames_expected} frames, "
                f"saw {self._frames_seen}")
        out = self._emit(self._cy, self._cw)
        self._cy = self._cw = None
        return out


class STFT:
    """Object front-end matching the reference TFTransform API.

    ``computeTransform(data)`` / ``invertTransform(X)``. Frequency axis
    first. Arrays go to `device`, the card unless the caller asks for
    "cpu" (a "cuda" request without a card raises). ``stream_blocks``
    reads a WAV file block by block.
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

    def stream_blocks(self, filename, frames_per_block: int,
                      start_block: int = 0):
        """Yield the STFT of a WAV file in blocks of frames_per_block
        frames ((F, Nb, I) complex on this transform's device; the last
        block may be shorter), reading only each block's samples
        (audio.wavread_block: a seek and a read), so memory stays
        O(frames_per_block). The blocks are bit-identical to the
        corresponding slices of computeTransform on the whole file (in
        float32; one framing core, _spec_from_padded), so

            torch.cat(list(st.stream_blocks(p, Nb)), dim=1)
            == st.computeTransform(wavread(p)[0].astype(np.float32))

        start_block skips ahead without reading the skipped samples
        (the resume of a checkpointed streaming estimation).
        """
        nsamples = wav_info(filename)["frames"]
        wlen, hop = self.wlen, self.hop
        pad_front, _, n_frames, _ = _frame_geometry(nsamples, wlen, hop)
        win = _window(self.window, wlen, torch.float32, self.device)
        for m0 in range(start_block * frames_per_block, n_frames,
                        frames_per_block):
            m1 = min(m0 + frames_per_block, n_frames)
            lo = m0 * hop - pad_front                    # may be < 0
            hi = (m1 - 1) * hop - pad_front + wlen       # may be > nsamples
            lo_c, hi_c = max(lo, 0), min(hi, nsamples)
            data, _ = wavread_block(filename, lo_c, hi_c - lo_c)
            chunk = np.pad(np.asarray(data, np.float32),
                           ((lo_c - lo, hi - hi_c), (0, 0)))
            yield _spec_from_padded(
                torch.as_tensor(chunk, device=self.device), win, wlen, hop,
                self.method)

    def synthesis_stream(self, nsamples: int) -> StreamingSynthesis:
        """Bounded-memory inverse: the dual of stream_blocks (see
        StreamingSynthesis)."""
        return StreamingSynthesis(nsamples, self.wlen, self.hop,
                                  self.window)

    forward = computeTransform
    inverse = invertTransform
