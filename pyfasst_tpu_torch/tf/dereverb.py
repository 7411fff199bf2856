"""Per-frequency multichannel linear-prediction dereverberation (WPE).

Port of pyfasst_tpu/tf/dereverb.py, copied unchanged: it is NumPy on the
host in both packages (init-time preprocessing of an (F, N, I) STFT plane;
pass a tensor through ``.cpu().numpy()``).

Weighted Prediction Error (Nakatani et al., 2010): in the STFT domain the
late reverberation of bin (f, n) is linearly predictable from the SAME
frequency's delayed frames, x_late(f, n) ~= G(f)^H x_stack(f, n - D ...
n - D - L + 1); subtracting the prediction leaves the direct sound +
early reflections. Per-frequency filters are solved in closed form from
variance-weighted normal equations, iterating the variance estimate
(classic WPE alternation, 2-3 rounds).

Scope caveat: WPE removes the linearly-PREDICTABLE part of each bin's
trajectory. Sustained tonal content (a stationary sine) is itself
predictable from delayed frames and gets cancelled along with the tail --
a speech/transient-regime tool; expect it to hurt sustained harmonic
(music) material.
"""
from __future__ import annotations

import numpy as np

__all__ = ["wpe_dereverb"]


def wpe_dereverb(X: np.ndarray, order: int = 8, delay: int = 2,
                 iters: int = 3, eps: float = 1e-8) -> np.ndarray:
    """WPE dereverberation of an STFT plane.

    X (F, N, I) complex; returns X_d of the same shape with the
    linearly-predictable late-reverberant component removed per
    frequency. order = taps per channel (L), delay = prediction gap D in
    frames (>= 1; 2 keeps early reflections with the direct path, the
    standard choice so the spatial signature stays intact), iters =
    variance re-estimation rounds.

    Fully vectorized over F: builds the (F, N, L*I) delayed stack once,
    then per-round solves the (L*I, L*I) regularized normal equations for
    all F at once (batched np.linalg.solve) -- host cost is O(F N L I)
    for the stacks plus O(F (LI)^3) for the solves, well under a second
    at music-lab shapes (F=1025, N~1700, L=8, I=2).
    """
    X = np.asarray(X)
    if X.ndim != 3:
        raise ValueError("X must be (F, N, I)")
    F, N, I = X.shape
    L = int(order)
    D = int(delay)
    if D < 1:
        raise ValueError("delay must be >= 1")
    if N <= D + L:
        return X.copy()

    # delayed stack: S[f, n, l*I + i] = X[f, n - D - l, i]
    S = np.zeros((F, N, L * I), X.dtype)
    for l in range(L):
        shift = D + l
        S[:, shift:, l * I:(l + 1) * I] = X[:, :N - shift, :]

    Xd = X.copy()
    for _ in range(iters):
        # variance of the current dereverberated estimate (floored to its
        # per-frequency mean * eps so silent bins don't explode weights)
        lam = np.mean(np.abs(Xd) ** 2, axis=-1)                   # (F, N)
        floor = eps * np.maximum(lam.mean(axis=1, keepdims=True), 1e-30)
        wv = 1.0 / np.maximum(lam, floor)                         # (F, N)

        Sw = S * wv[..., None]
        R = np.einsum("fna,fnb->fab", Sw, np.conj(S))     # (F, LI, LI)
        P = np.einsum("fna,fni->fai", Sw, np.conj(X))     # (F, LI, I)
        tr = np.real(np.einsum("faa->f", R)) / (L * I)
        ridge = (1e-6 * np.maximum(tr, 1e-30))[:, None, None] \
            * np.eye(L * I)
        G = np.linalg.solve(R + ridge, P)                 # (F, LI, I)
        Xd = X - np.einsum("fna,fai->fni", S, np.conj(G))
    return Xd
