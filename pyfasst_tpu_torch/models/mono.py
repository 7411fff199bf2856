"""Blind mono spectral init: mixture IS-NMF + envelope clustering.

Port of pyfasst_tpu/models/mono.py: is_nmf, _kmeans_corr and
nmf_cluster_init are copied as they are (NumPy, float64, on the host);
apply_mono_init installs the result on the port's FasstParams.

With no spatial cues, a mono separation's quality is decided by where the
spectral factors start. The classic mono-NMF recipe, done as an init
rather than as a post-hoc mask: factorize the mixture power once with
J*K components, group the components into J sources by clustering their
time-envelope correlations, and initialize each source's FB/TW from its
group; the GEM fit then refines from there. The JAX package measured
3.2 dB from a random init and 11.5 dB from this one on its validation
mono fixture, and over five independent draws a worst/median of -1.36/
2.05 dB against the random init's 0.37/3.75: the init wins when envelope
clusters track sources (gated or switched material) and loses when a
source's components split across clusters (steady band-limited pairs).
So it stays an opt-in path (FASST.estim_param_blind_mono and
separate_streaming(init="blind") on mono input).

The decision-feeding computation (the NMF and the clustering) runs on the
host in float64, whatever device the model is on.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["is_nmf", "nmf_cluster_init", "apply_mono_init"]


def is_nmf(P: np.ndarray, K: int, iters: int = 200, seed: int = 0,
           eps: float = 1e-9) -> Tuple[np.ndarray, np.ndarray]:
    """Plain float64 IS-NMF P ~ W @ H (multiplicative updates).

    Host-side by design (decision-feeding; see module docstring). Columns
    of W are normalized to unit sum with the scale pushed into H.
    """
    rng = np.random.default_rng(seed)
    F, N = P.shape
    W = 0.5 + rng.random((F, K))
    H = 0.5 + rng.random((K, N))
    P = np.maximum(np.asarray(P, np.float64), eps)
    for _ in range(iters):
        V = np.maximum(W @ H, eps)
        W *= ((P / V ** 2) @ H.T) / np.maximum((1.0 / V) @ H.T, eps)
        V = np.maximum(W @ H, eps)
        H *= (W.T @ (P / V ** 2)) / np.maximum(W.T @ (1.0 / V), eps)
    s = W.sum(0, keepdims=True)
    return W / np.maximum(s, eps), H * s.T


def _kmeans_corr(C: np.ndarray, J: int, seed: int) -> np.ndarray:
    """Spherical k-means on a correlation matrix's rows (labels (K,))."""
    r = np.random.default_rng(seed)
    lab = r.integers(0, J, C.shape[0])
    for _ in range(100):
        cent = np.stack([C[lab == j].mean(0) if (lab == j).any()
                         else r.standard_normal(C.shape[0])
                         for j in range(J)])
        new = np.argmax(cent @ C, axis=0)
        if np.array_equal(new, lab):
            break
        lab = new
    return lab


def nmf_cluster_init(X: np.ndarray, J: int, nmf_comps: int,
                     nmf_iters: int = 200, n_seeds: int = 4,
                     seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Blind mono spectral init: [(FB_j, TW_j)] * J, each (F, K)/(K, N).

    X: (F, N) or (F, N, 1) complex mixture spectrogram. Factorizes
    |X|^2 with J*nmf_comps components, clusters the components' centered
    log-envelopes by correlation (k-means over `n_seeds` restarts, best
    within-cluster coherence wins), and packs each group's components
    into an exactly-K init per source: groups larger than K keep their K
    highest-energy components, smaller groups pad with tiny random ones
    (static shapes — the model's K is a compile-time constant).
    """
    X = np.asarray(X)
    if X.ndim == 3:
        X = X[..., 0]
    P = np.abs(X) ** 2
    F, N = P.shape
    K = int(nmf_comps)
    W, H = is_nmf(P, J * K, iters=nmf_iters, seed=seed)

    E = np.log1p(H / np.maximum(H.mean(1, keepdims=True), 1e-12))
    E = E - E.mean(1, keepdims=True)
    E /= np.maximum(np.linalg.norm(E, axis=1, keepdims=True), 1e-12)
    C = E @ E.T

    best_lab, best_score = None, -np.inf
    for s in range(n_seeds):
        lab = _kmeans_corr(C, J, seed + s)
        if len(set(lab.tolist())) < J:
            continue
        # within-cluster mean correlation, worst cluster (a grouping that
        # leaves one incoherent cluster should lose even if others shine)
        score = min(float(C[np.ix_(lab == j, lab == j)].mean())
                    for j in range(J))
        if score > best_score:
            best_lab, best_score = lab, score
    if best_lab is None:                       # all restarts degenerate
        best_lab = np.arange(J * K) % J
    energy = (W.sum(0) * H.sum(1))             # per-component energy

    rng = np.random.default_rng(seed + 1000)
    out = []
    for j in range(J):
        idx = np.where(best_lab == j)[0]
        idx = idx[np.argsort(-energy[idx])][:K]
        Wj, Hj = W[:, idx], H[idx]
        k = Wj.shape[1]
        if k < K:                              # pad to the static K
            Wj = np.concatenate(
                [Wj, 1e-3 * (0.5 + rng.random((F, K - k)))], 1)
            Hj = np.concatenate(
                [Hj, 1e-3 * (0.5 + rng.random((K - k, N)))], 0)
        out.append((Wj, np.maximum(Hj, 1e-6)))
    return out


def apply_mono_init(params, init) -> "FasstParams":  # noqa: F821
    """Install nmf_cluster_init's [(FB_j, TW_j)] on a FasstParams (one
    spectral component per source, NMF constraint, clip axis B = 1), on
    the device and in the dtype of the params' own factors."""
    spec = []
    for j, sc in enumerate(params.spec):
        Wj, Hj = init[j]
        if sc.FB.shape[1:] != Wj.shape or sc.TW.shape[1:] != Hj.shape:
            raise ValueError(
                f"mono init shape mismatch for source {j}: model "
                f"{tuple(sc.FB.shape[1:])}/{tuple(sc.TW.shape[1:])} vs init "
                f"{Wj.shape}/{Hj.shape}")
        spec.append(sc.replace(
            FB=torch.as_tensor(Wj, dtype=sc.FB.dtype,
                               device=sc.FB.device)[None],
            TW=torch.as_tensor(Hj, dtype=sc.TW.dtype,
                               device=sc.TW.device)[None]))
    return params.replace(spec=tuple(spec))
