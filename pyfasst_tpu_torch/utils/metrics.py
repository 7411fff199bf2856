"""Separation quality metrics and benchmark helpers.

Port of pyfasst_tpu/utils/metrics.py, which is host-side NumPy: this is
its copy, so the port scores separations without importing the JAX
package. BSS-Eval SDR/SIR/SAR (Vincent, Gribonval & Fevotte 2006): each
estimate is projected onto the subspace spanned by time-shifted references
(filt_len-tap allowed distortion filters, default 128), the error split
into interference and artifact parts, and the permutation chosen for the
best match.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np


def _ridge_solve(G: np.ndarray, D: np.ndarray) -> np.ndarray:
    """Solve (G + ridge I) c = D; lstsq fallback for degenerate Grams."""
    n = len(G)
    Greg = G + 1e-9 * np.trace(G) / max(n, 1) * np.eye(n)
    try:
        return np.linalg.solve(Greg, D)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(Greg, D, rcond=None)[0]


def _shifted_gram_projection(est: np.ndarray, refs: np.ndarray, L: int):
    """Least-squares projection of `est` onto span{0..L-1 sample shifts of
    the references} (the BSS-Eval allowed-distortion subspace, Vincent,
    Gribonval & Fevotte 2006).

    est: (T,), refs: (J, T). Returns (est_pad, proj_all, proj_each[J]) on
    the padded support T + L - 1, where proj_all uses all references
    jointly and proj_each[j] only reference j.

    All inner products are FFT cross-correlations and the Gram is assembled
    from its block-Toeplitz lag structure: G[(j,a),(j',b)] = r_{jj'}(b-a)
    with r the linear cross-correlation, D[(j,a)] = sum_t refs[j,t]
    est[t+a]. Cost O(J^2 (T+L) log(T+L) + (J L)^3) time, O(J (T+L) + (JL)^2)
    memory -- the round-2 dense version materialized a (J L, T) shift matrix
    and its Gram by explicit matmul, >10 GB at the literature operating
    point (filt_len 512, 30 s @ 44.1 kHz); this one scores it in seconds.
    """
    est = np.asarray(est, np.float64)
    refs = np.asarray(refs, np.float64)
    J, T = refs.shape
    n = T + L - 1
    nfft = 1 << max(n - 1, 1).bit_length()
    SF = np.fft.rfft(refs, nfft, axis=1)                     # (J, K)
    EF = np.fft.rfft(est, nfft)
    # lag index grid: block entry (a, b) is cross-correlation at lag b - a
    idx = (np.arange(L)[None, :] - np.arange(L)[:, None]) % nfft
    G = np.empty((J, L, J, L))
    for i in range(J):
        for j in range(i, J):
            # c[k] = sum_t refs[i, t] refs[j, t - k] (linear: nfft >= T+L-1)
            c = np.fft.irfft(SF[i] * np.conj(SF[j]), nfft)
            G[i, :, j, :] = c[idx]
            if j > i:
                G[j, :, i, :] = c[idx].T
    G = G.reshape(J * L, J * L)
    D = np.empty((J, L))
    dlag = (-np.arange(L)) % nfft
    for j in range(J):
        sef = np.fft.irfft(SF[j] * np.conj(EF), nfft)
        D[j] = sef[dlag]                  # sum_t refs[j, t] est[t + a]
    coef = _ridge_solve(G, D.reshape(-1)).reshape(J, L)
    # projection = sum_j refs[j] * coef[j] (linear convolution, length n)
    CF = np.fft.rfft(coef, nfft, axis=1)
    proj_all = np.fft.irfft((SF * CF).sum(axis=0), nfft)[:n]
    projs_each = np.empty((J, n))
    for j in range(J):
        Gj = G[j * L:(j + 1) * L, j * L:(j + 1) * L]
        cj = _ridge_solve(Gj, D[j])
        projs_each[j] = np.fft.irfft(
            SF[j] * np.fft.rfft(cj, nfft), nfft)[:n]
    est_pad = np.zeros(n)
    est_pad[:T] = est
    return est_pad, proj_all, projs_each


def bss_eval_sources(est: np.ndarray, ref: np.ndarray, filt_len: int = 128
                     ) -> Dict[str, np.ndarray]:
    """BSS-Eval SDR/SIR/SAR with best permutation.

    est, ref: (J, T) mono source signals (mix multichannel images down or
    evaluate per channel). Returns dict with 'sdr', 'sir', 'sar' (J,) for
    the best permutation and 'perm'.
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    J, T = ref.shape
    sdr = np.full((J, J), -np.inf)
    sir = np.zeros((J, J))
    sar = np.zeros((J, J))
    for i in range(J):          # estimate i
        est_pad, proj_all, proj_each = _shifted_gram_projection(
            est[i], ref, filt_len)
        artifact = est_pad - proj_all
        for j in range(J):      # against reference j
            s_target = proj_each[j]
            e_interf = proj_all - s_target
            denom_sdr = np.sum((e_interf + artifact) ** 2)
            sdr[i, j] = 10 * np.log10(np.sum(s_target ** 2)
                                      / max(denom_sdr, 1e-12))
            sir[i, j] = 10 * np.log10(np.sum(s_target ** 2)
                                      / max(np.sum(e_interf ** 2), 1e-12))
            sar[i, j] = 10 * np.log10(np.sum((s_target + e_interf) ** 2)
                                      / max(np.sum(artifact ** 2), 1e-12))
    best, best_perm = None, None
    for perm in itertools.permutations(range(J)):
        tot = sum(sdr[perm[j], j] for j in range(J))
        if best is None or tot > best:
            best, best_perm = tot, perm
    p = list(best_perm)
    return {
        "sdr": np.array([sdr[p[j], j] for j in range(J)]),
        "sir": np.array([sir[p[j], j] for j in range(J)]),
        "sar": np.array([sar[p[j], j] for j in range(J)]),
        "perm": np.array(p),
    }


def bss_eval_images(est: np.ndarray, ref: np.ndarray, filt_len: int = 512
                    ) -> Dict[str, np.ndarray]:
    """BSS-Eval SDR for multichannel source IMAGES at the best permutation.

    est, ref: (J, T, I) source images (the Wiener estimates target images,
    SURVEY.md §A separation). Per-channel variant of bss_eval_images
    (Vincent et al. 2007): channel i of estimate j is projected onto the
    filt_len-shift subspace of ALL references' channel i; distortion power
    is summed over channels before the log. Default filt_len=512 is the
    literature operating point (tractable here because the projector is
    FFT/Toeplitz -- the round-2 dense version was >10 GB at this setting).
    Returns {'sdr' (J,), 'perm'}.
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    J, T, I = ref.shape
    num = np.zeros((J, J))          # target power, est i vs ref j
    den = np.zeros((J, J))          # distortion power
    for ch in range(I):
        refs_ch = ref[:, :, ch]
        for i in range(J):
            est_pad, proj_all, proj_each = _shifted_gram_projection(
                est[i, :, ch], refs_ch, filt_len)
            artifact = est_pad - proj_all
            for j in range(J):
                s_target = proj_each[j]
                e_interf = proj_all - s_target
                num[i, j] += np.sum(s_target ** 2)
                den[i, j] += np.sum((e_interf + artifact) ** 2)
    sdr = 10 * np.log10(np.maximum(num, 1e-12) / np.maximum(den, 1e-12))
    best, best_perm = None, None
    for perm in itertools.permutations(range(J)):
        tot = sum(sdr[perm[j], j] for j in range(J))
        if best is None or tot > best:
            best, best_perm = tot, perm
    p = list(best_perm)
    return {"sdr": np.array([sdr[p[j], j] for j in range(J)]),
            "perm": np.array(p)}


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR of one estimate against one reference (T,)."""
    est = np.asarray(est, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    alpha = float(est @ ref) / max(float(ref @ ref), 1e-12)
    return 10 * np.log10(max(np.sum((alpha * ref) ** 2), 1e-12)
                         / max(np.sum((est - alpha * ref) ** 2), 1e-12))


def xrt(audio_seconds: float, wall_seconds: float, n_chips: int = 1) -> float:
    """The BASELINE.json throughput metric: audio-sec / sec / chip."""
    return audio_seconds / max(wall_seconds, 1e-12) / n_chips
