"""DEMIX: blind anechoic mixing-parameter estimation for initialization.

Port of pyfasst_tpu/models/demix.py. It is NumPy and SciPy and runs on the
host; only the STFT of an audio input is the port's (torch, on the CPU).
The idea is Arberet, Gribonval & Bimbot's DEMIX: find time-frequency
regions where ONE source dominates (local covariance is near rank-1), read
the mixing direction off the principal eigenvector, and cluster the
directions into K anechoic (gain, delay) parameters.

The local covariance smoothing and the closed-form 2x2 eigendecomposition
are vectorized over the whole (f, n) plane; the clustering of (log-gain,
lagged-phase-slope) features is a density-peel-seeded trimmed k-means.
Returns mixing matrices ready to seed MultiChanNMFConv (configs[1]), or,
rank-expanded, the full-rank models (configs[2]).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pyfasst_tpu_torch.tf.stft import STFT


def _box_smooth(x: np.ndarray, wf: int, wn: int) -> np.ndarray:
    """Separable box filter over the leading two axes (F, N[, ...])."""
    from scipy.ndimage import uniform_filter1d
    if np.iscomplexobj(x):
        return (_box_smooth(x.real, wf, wn)
                + 1j * _box_smooth(x.imag, wf, wn))
    out = uniform_filter1d(x, wf, axis=0, mode="nearest")
    return uniform_filter1d(out, wn, axis=1, mode="nearest")


def local_directions(X: np.ndarray, wf: int = 3, wn: int = 8):
    """Per-bin principal direction + confidence of the smoothed covariance.

    X: (F, N, 2) complex. Returns (u, conf): u (F, N, 2) complex unit
    principal eigenvectors, conf (F, N) = lambda1/lambda2 (>= 1; large where
    a single source locally dominates -- DEMIX's selection criterion).
    """
    a = _box_smooth(np.abs(X[..., 0]) ** 2, wf, wn)
    d = _box_smooth(np.abs(X[..., 1]) ** 2, wf, wn)
    b = _box_smooth(X[..., 0] * np.conj(X[..., 1]), wf, wn)
    half = 0.5 * (a + d)
    disc = np.sqrt(np.maximum(0.25 * (a - d) ** 2 + np.abs(b) ** 2, 0.0))
    lam1 = half + disc
    lam2 = np.maximum(half - disc, 1e-30)
    u0 = b
    u1 = lam1 - a
    # fall back to the axis vector when b ~ 0 (diagonal covariance)
    degenerate = np.abs(u0) + np.abs(u1) < 1e-12 * np.maximum(lam1, 1e-30)
    u0 = np.where(degenerate, (a >= d).astype(complex), u0)
    u1 = np.where(degenerate, (a < d).astype(complex), u1)
    norm = np.sqrt(np.abs(u0) ** 2 + np.abs(u1) ** 2) + 1e-30
    u = np.stack([u0 / norm, u1 / norm], axis=-1)
    conf = lam1 / lam2
    return u, conf, lam1


def _peel_seeds(z: np.ndarray, w: np.ndarray, K: int,
                n_candidates: int = 2048) -> np.ndarray:
    """DEMIX-style sequential seeding by LOCAL DENSITY: find the densest
    mode of the remaining features, mean-shift onto it, REMOVE its
    neighbourhood, repeat K times.

    Density, not per-point confidence, picks the seed: the confidence
    weights saturate at their cap for most selected bins, so an argmax over
    them is arbitrary. And inertia-selected random restarts systematically
    split the heaviest cluster instead of keeping a light one when sources
    have very unequal bin counts -- peeling seeds one centroid per mode
    regardless of its weight share. z is in cluster-width units.
    """
    rng = np.random.default_rng(0)
    z_rem, w_rem = z, w
    seeds = []
    for _ in range(K):
        if len(z_rem) == 0:
            seeds.append(seeds[-1] + 1.0)            # degenerate fallback
            continue
        cand = z_rem[rng.choice(len(z_rem),
                                min(n_candidates, len(z_rem)),
                                replace=False)]
        d2 = np.sum((cand[:, None, :] - z_rem[None, :, :]) ** 2, axis=-1)
        density = (w_rem * (d2 < 1.5 ** 2)).sum(axis=1)
        c = cand[int(np.argmax(density))]
        for _ in range(3):                           # local mean-shift
            close = np.sum((z_rem - c) ** 2, axis=1) < 1.5 ** 2
            if not np.any(close):
                break
            c = np.average(z_rem[close], axis=0, weights=w_rem[close])
        seeds.append(c)
        far = np.sum((z_rem - c) ** 2, axis=1) >= 2.5 ** 2
        z_rem, w_rem = z_rem[far], w_rem[far]
    return np.stack(seeds)


def _weighted_kmeans(z: np.ndarray, w: np.ndarray, K: int, n_iter: int = 50,
                     trim_radius: float = 3.0) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Peel-seeded, TRIMMED weighted k-means in cluster-width units.

    z must already be scaled so one unit ~ one cluster width per feature
    (DEMIX._cluster_scale). Two robustness properties matter here and plain
    inertia-minimizing k-means has neither:
      - seeds come from peeling (one per dominance region), because the
        minimum-inertia solution SPLITS a heavy cluster rather than keep a
        light one when sources have very unequal bin counts;
      - the centroid update is trimmed to points within `trim_radius`
        cluster widths, because heavy-tailed slope noise otherwise drags
        centroids off their clusters (weighted means are not robust).
    """
    centers = _peel_seeds(z, w, K)
    labels = np.zeros(len(z), np.int64)
    for _ in range(n_iter):
        d2 = np.stack([np.sum((z - c) ** 2, axis=1) for c in centers])
        labels = np.argmin(d2, axis=0)
        near = np.min(d2, axis=0) < trim_radius ** 2
        for k in range(K):
            m = (labels == k) & near
            if np.any(m):
                centers[k] = np.average(z[m], axis=0, weights=w[m])
    return centers, labels


class DEMIX:
    """Estimate K anechoic mixing vectors a_k(f) = [1, g_k e^{-i pi f d_k/(F-1)}].

    Parameters mirror the reference's usage: construct from audio (or a
    precomputed STFT), call `comp_parameters(K)`, then `mixing(F)` for the
    (K, F, 2, 1) initialization of MultiChanNMFConv.
    """

    def __init__(self, audio=None, X: Optional[np.ndarray] = None,
                 fs: int = 44100, wlen: int = 1024,
                 conf_quantile: float = 0.8, wf: int = 3, wn: int = 8,
                 max_delay: float = 32.0, max_gain: float = 30.0,
                 slope_lag: int = 8):
        if X is None:
            from pyfasst_tpu_torch.audio import AudioObject
            if isinstance(audio, AudioObject):
                obj = audio
            elif isinstance(audio, np.ndarray):
                obj = AudioObject(data=audio, samplerate=fs)
            else:
                obj = AudioObject(audio)
            tft = STFT(wlen=wlen, fs=obj.samplerate, device="cpu")
            X = tft.computeTransform(obj.data.astype(np.float32)).numpy()
        self.X = np.asarray(X)
        self.F = self.X.shape[0]
        self.conf_quantile = conf_quantile
        self.wf, self.wn = wf, wn
        self.max_delay = float(max_delay)
        self.max_gain = float(max_gain)
        self.slope_lag = int(slope_lag)
        self.gains: Optional[np.ndarray] = None
        self.delays: Optional[np.ndarray] = None

    # -- reference API -------------------------------------------------------
    def comp_pcafeatures(self):
        """Local PCA of covariance neighbourhoods -> directions+confidence."""
        self.u, self.conf, self.lam1 = local_directions(self.X, self.wf,
                                                        self.wn)
        return self.u, self.conf

    # One cluster width per feature, in (log-gain, delay-samples): set by
    # the slope-estimator noise, NOT by data spread (std-based scaling is
    # inflated by heavy delay tails and collapses the delay axis, making
    # distances gain-dominated).
    _cluster_scale = np.array([0.15, 1.2])

    def estimate_count(self, K_max: int = 6,
                       var_floor: float = 0.05 ** 2) -> int:
        """Estimate the source count K^ (reference DEMIX estimates it too).

        BIC over isotropic Gaussian mixtures induced by the weighted
        k-means labels: for each K, fit per-cluster (mean, variance, mass)
        and score -2 * weighted log-likelihood + (4K - 1) * log(sum w).
        Unlike the global-inertia elbow rule this is a PER-POINT criterion:
        a source holding a small fraction of the confident bins still earns
        its own component, because its points' likelihood under a far
        centroid is individually terrible even when their total inertia
        share is negligible. `var_floor` (in cluster-width units) stops a
        one-point cluster from collapsing its variance to zero.
        """
        z, w = self._features()
        z = z / self._cluster_scale
        W = float(w.sum())
        best, best_K = np.inf, 1
        for K in range(1, K_max + 1):
            centers, labels = _weighted_kmeans(z, w, K)
            pis, vs = [], []
            for k in range(K):
                m = labels == k
                Wk = float(w[m].sum())
                if Wk <= 0.0:                       # empty cluster: dead
                    pis.append(1e-12)
                    vs.append(var_floor)
                    continue
                d2 = np.sum((z[m] - centers[k]) ** 2, axis=1)
                vs.append(max(float(np.average(d2, weights=w[m])) / 2.0,
                              var_floor))
                pis.append(Wk / W)
            pis, vs = np.asarray(pis), np.asarray(vs)
            d2all = np.stack([np.sum((z - c) ** 2, axis=1) for c in centers])
            logp = (np.log(pis)[:, None] - np.log(2 * np.pi * vs)[:, None]
                    - d2all / (2 * vs[:, None]))
            mx = logp.max(axis=0)
            ll = float(np.sum(
                w * (mx + np.log(np.sum(np.exp(logp - mx), axis=0)))))
            bic = -2.0 * ll + (4 * K - 1) * np.log(W)
            if bic < best:
                best, best_K = bic, K
        return best_K

    def comp_parameters(self, K: Optional[int] = None, refine: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Cluster confident bins -> (gains[K], delays[K] in samples).

        K=None estimates the source count first (estimate_count).
        refine runs the sub-sample (gain, delay) refinement -- REQUIRED
        for EM seeding: a conv-mixing EM cannot recover from a ~1-sample
        delay error in its init (each frequency's solve is local, and a
        wrong global phase ramp is a per-frequency-consistent local
        optimum). Measured on the configs[1] fixture: oracle steering
        with ONE source's delay off by 1.06 samples drops min SDR from
        17.3 to 2.3 dB; the k-means centroid estimate carries exactly
        that kind of error."""
        if K is None:
            K = self.estimate_count()
        z, w = self._features()
        centers, _ = _weighted_kmeans(z / self._cluster_scale, w, K)
        centers = centers * self._cluster_scale
        self.gains = np.exp(centers[:, 0])
        self.delays = -centers[:, 1]
        if refine:
            self.refine_parameters()
        return self.gains, self.delays

    def refine_parameters(self, n_iter: int = 3, span: float = 2.0,
                          step: float = 0.02) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """Sub-sample (gain, delay) refinement of the clustered estimates.

        Alternates (a) assigning each confident bin's local direction
        u(f, n) to the best-fitting anechoic steering vector
        a_k(f) = [1, g_k e^{-i pi f d_k/(F-1)}], and (b) per-source
        delay re-fit by a fine grid search maximizing the coherently
        delay-compensated sum |sum w u1 u0* e^{+i pi f d/(F-1)}| (the
        classic GCC objective over the cluster's bins) plus a weighted
        least-squares gain re-fit. Grid step 0.02 samples over +-span
        around the current estimate; three sweeps converge to ~0.01
        sample on the validation fixtures."""
        F = self.F
        # Two data views, used for different jobs:
        # - ASSIGNMENT uses the smoothed local-PCA directions u (the
        #   (wf, wn) covariance smoothing denoises dominance, so the
        #   per-bin source attribution is reliable);
        # - the DELAY FIT uses the RAW per-bin cross-spectra of the
        #   cleanly-assigned bins (the same smoothing mixes adjacent
        #   bins' phases across source boundaries and biases the fitted
        #   delay by ~0.3-0.5 samples -- enough to sink the EM seed, see
        #   comp_parameters; raw phases of dominated bins are unbiased).
        u, conf, lam1 = self.u, self.conf, self.lam1
        energy = lam1.ravel()
        loud = energy >= 1e-3 * energy.mean()
        w = np.minimum(conf.ravel(), 100.0)[loud]
        fidx = np.broadcast_to(np.arange(F)[:, None],
                               lam1.shape).ravel()[loud]
        u0 = u[..., 0].ravel()[loud]
        u1 = u[..., 1].ravel()[loud]
        x0 = self.X[..., 0].ravel()[loud]
        x1 = self.X[..., 1].ravel()[loud]
        cross = x1 * np.conj(x0)
        nrm = (np.abs(u0) ** 2 + np.abs(u1) ** 2)
        K = len(self.gains)
        offs = np.arange(-span, span + step / 2, step)
        phat = cross / np.maximum(np.abs(cross), 1e-20)

        def alternate(gains0, delays0):
            gains, delays = gains0.copy(), delays0.copy()
            for _ in range(n_iter):
                theta = (np.pi * fidx[None, :] / (F - 1)) * delays[:, None]
                sim = np.abs(u0[None] + gains[:, None] * np.exp(1j * theta)
                             * u1[None]) ** 2 \
                    / np.maximum(nrm[None] * (1.0 + gains[:, None] ** 2),
                                 1e-20)
                order = np.sort(sim, axis=0)
                lab = np.argmax(sim, axis=0)
                # dominance-margin gate: a bin that fits two steering
                # vectors almost equally well (cross-source contamination,
                # band boundaries) pulls the delay fit between sources
                clean = (order[-1] - order[-2]) > 0.1 * order[-1] \
                    if K > 1 else np.ones(len(lab), bool)
                for k in range(K):
                    m = (lab == k) & clean
                    if not np.any(m):
                        continue
                    d_grid = delays[k] + offs
                    ph = np.exp(1j * (np.pi / (F - 1))
                                * d_grid[:, None] * fidx[None, m])
                    # PHAT weighting: phase-only cross spectra stop loud
                    # contaminated bins from dominating the coherent sum
                    J = np.abs(ph @ (w[m] * phat[m]))
                    delays[k] = d_grid[int(np.argmax(J))]
                    den = float(np.sum(w[m] * np.abs(u0[m]) ** 2))
                    if den > 0:
                        gains[k] = float(np.sum(
                            w[m] * np.abs(u0[m]) * np.abs(u1[m]))) / den
            # Model-fit score: how well the K fitted anechoic steering
            # vectors explain the smoothed per-bin directions. (Total
            # PHAT coherence was tried first and misranks: it ignores the
            # gain axis and rewards piling bins onto fewer delay lobes.)
            theta = (np.pi * fidx[None, :] / (F - 1)) * delays[:, None]
            sim = np.abs(u0[None] + gains[:, None] * np.exp(1j * theta)
                         * u1[None]) ** 2 \
                / np.maximum(nrm[None] * (1.0 + gains[:, None] ** 2),
                             1e-20)
            score = float(np.sum(w * sim.max(axis=0)))
            return gains, delays, score

        # Two seedings, best total PHAT coherence wins. The k-means delay
        # centroids mis-seed when true delays sit close together (slope-
        # feature noise merges basins; observed: true {3.3, 0, 1.8} seeded
        # as {1.8, 4.4, 3.6} and the local grid search cannot escape a
        # wrong basin). Global GCC-PHAT peaks over ALL bins provide an
        # independent delay seeding immune to that failure.
        cands = [alternate(self.gains, self.delays)]
        peaks = self._gcc_peak_delays(w, phat, fidx, K)
        if peaks is not None:
            # pair each peak with the unclaimed k-means gain whose
            # centroid delay is nearest (keeps approximate (g, d) pairing)
            g_seed = np.empty(K)
            used = np.zeros(K, bool)
            for i, d in enumerate(peaks):
                dist = np.where(used, np.inf, np.abs(self.delays - d))
                j = int(np.argmin(dist))
                used[j] = True
                g_seed[i] = self.gains[j]
            cands.append(alternate(g_seed, np.asarray(peaks)))
        gains, delays, _ = max(cands, key=lambda t: t[2])
        self.gains, self.delays = gains, delays
        return gains, delays

    def _gcc_peak_delays(self, w, phat, fidx, K: int,
                         coarse_step: float = 0.1,
                         min_sep: float = 0.75):
        """Top-K separated peaks of the global weighted GCC-PHAT objective
        |sum w phat e^{+i pi f d/(F-1)}| over d in [-max_delay, max_delay].
        Returns None if fewer than K separated peaks exist."""
        F = self.F
        d_grid = np.arange(-self.max_delay, self.max_delay + coarse_step / 2,
                           coarse_step)
        if len(fidx) > 20000:            # the peak landscape saturates
            sel = np.random.default_rng(0).choice(
                len(fidx), 20000, replace=False,
                p=w / max(w.sum(), 1e-30))
            w, phat, fidx = w[sel], phat[sel], fidx[sel]
        wp = w * phat
        J = np.empty(len(d_grid))
        for i0 in range(0, len(d_grid), 64):          # chunk the grid
            dg = d_grid[i0:i0 + 64]
            ph = np.exp(1j * (np.pi / (F - 1))
                        * dg[:, None] * fidx[None, :])
            J[i0:i0 + 64] = np.abs(ph @ wp)
        peaks = []
        for i in np.argsort(-J):
            d = d_grid[i]
            if all(abs(d - p) > min_sep for p in peaks):
                peaks.append(float(d))
            if len(peaks) == K:
                return peaks
        return None

    def _features(self) -> Tuple[np.ndarray, np.ndarray]:
        """(features z (M, 2), weights w (M,)) of confident loud bins;
        z columns are (log gain, delay in samples), pre-scaling."""
        self.comp_pcafeatures()
        u, conf, lam1 = self.u, self.conf, self.lam1
        L = self.slope_lag
        # feature 1: log gain ratio |u1/u0|
        g = np.abs(u[..., 1]) / np.maximum(np.abs(u[..., 0]), 1e-12)
        # feature 2: phase increment of u1 u0* across an L-bin frequency
        # lag: equals -pi L delay / (F-1). The lag is the delay-resolution
        # lever: per-pair phase noise is ~constant, so the implied delay
        # noise scales as 1/L (adjacent bins, L=1, give clusters many
        # samples wide for |d| ~ 5 and k-means cannot separate sources).
        # Wrap-safe for |d| < (F-1)/L, consistent with the max_delay gate.
        prod = u[..., 1] * np.conj(u[..., 0])
        slope = np.angle(prod[L:] * np.conj(prod[:-L]))        # (F-L, N)
        logg = np.log(np.maximum(g, 1e-9))
        gmid = 0.5 * (logg[L:] + logg[:-L])
        # endpoint-consistency gate: a pair whose two bins sit in DIFFERENT
        # sources' territory reads a meaningless slope (and such pairs are
        # plentiful at band boundaries once L > 1, spawning spurious
        # clusters). Same-source endpoints agree on the gain ratio.
        consistent = (np.abs(logg[L:] - logg[:-L]) < 0.3).ravel()
        # selection: silent bins have 0/0 covariances and garbage-huge
        # confidence -- gate on local ENERGY first, then on confidence,
        # and cap the k-means weights.
        energy = np.minimum(lam1[L:], lam1[:-L]).ravel()
        w = np.minimum(conf[L:], conf[:-L]).ravel()
        z = np.stack([gmid.ravel(), slope.ravel()
                      * (self.F - 1) / (np.pi * L)], axis=1)
        loud = (energy >= 1e-3 * energy.mean()) & consistent
        # cap the confidence weights HARD: conf scales like 1/(direction
        # rotation)^2 within the smoothing window, which biases raw-conf
        # selection toward small-delay sources; past ~confident it carries
        # no extra information.
        z, w = z[loud], np.minimum(w[loud], 100.0)
        # physical-bounds gate: slope features wrap for large effective
        # delays and explode on cross-source bins; without it, a handful of
        # garbage features (|delay| in the hundreds, gains in the hundreds)
        # sit far from every real cluster and CAPTURE a k-means centroid,
        # losing one true source (observed on a 3-source mixture).
        sane = (np.abs(z[:, 1]) <= self.max_delay) \
            & (np.abs(z[:, 0]) <= np.log(self.max_gain))
        z, w = z[sane], w[sane]
        keep = w >= np.quantile(w, self.conf_quantile)
        return z[keep], w[keep]

    def mixing(self, F: Optional[int] = None) -> np.ndarray:
        """(K, F, 2, 1) complex anechoic mixing matrices for model init."""
        if self.gains is None:
            raise RuntimeError("call comp_parameters(K) first")
        F = F or self.F
        f = np.arange(F)
        A = np.stack([
            np.stack([np.ones(F, complex),
                      g * np.exp(-1j * np.pi * f * d / (F - 1))], axis=1)
            for g, d in zip(self.gains, self.delays)])
        return A[..., None]
