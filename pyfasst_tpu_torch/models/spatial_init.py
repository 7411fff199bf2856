"""Blind full-rank spatial initialization for reverberant mixtures.

Port of pyfasst_tpu/models/spatial_init.py. The host core (features,
per-frequency clustering, spectral permutation alignment, consensus
voting, vote repairs, the candidate families, mixing from votes, activity
profiles) is the JAX package's NumPy code, copied as it stands: the same
inputs give the same bits. What the JAX package runs as jitted device
programs runs here in PyTorch on an explicit `device` (the card unless the
caller asks for "cpu"), in full float32 (utils/precision.highest_precision,
no TF32), because every one of these outputs feeds an argmin, an argmax or
a rounded selection key:

    _cluster_labels_device, _consensus_votes_device   the seeds' batched
        warm-started per-frequency k-means over (S, F, N) (backend
        "device"; the JAX package calls it "jax")
    _lanczos_top, _embed_nodes_device                  the graph build and
        Lanczos of the alignment above F*J = 2052 nodes
    _max_env_corr, _min_band_coherence, _band_coherence_stats
        the blind degeneracy statistics, over a leading batch axis of runs
        (the JAX package vmaps its single-run versions)
    select_init_by_likelihood                          all probes as one
        batched run_gem / separate_sources call over the clip axis
    _band_em_probes, glue_band_perms                   the band-local
        EM probes and the pairwise glue EMs, batched the same way

Recipe (Duong/Sawada lineage, as the JAX package documents it):
1. per-(f, n) normalized covariance features, scale-invariant spatial
   signatures including the reverberant part;
2. per-frequency weighted k-means over frames, warm-started from a global
   clustering of a subsample;
3. per-frequency permutation alignment by spectral clustering of the
   (frequency, cluster) envelope-correlation graph;
4. consensus over several k-means seeds;
4b. structural repair hypotheses (merge+split of envelope-correlated
   cluster pairs, direction-first NMF splits), picked by vetoed model
   evidence;
5. full-rank R_j(f) from the votes; its eigenvectors give the mixing
   columns of MultiChanNMFConv(spatial_rank=2, init_mixing=...);
6. per-source activity profiles that modulate the random TW/FB init.
7. optionally, band-local EM probes whose converged dominance labels,
   aligned across bands, give one more vote plane (band_em_votes).

n_devices > 1 runs the pools on a mesh of that many ranks of an
initialized process group (parallel/sharding.py; launch with torchrun),
padded to a multiple of its dp axis as the JAX package pads them.
"""
from __future__ import annotations

from itertools import permutations
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pyfasst_tpu_torch.parallel.sharding import (
    batch_params, batched_run_gem, make_mesh, sharded_batch_separate,
)
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyfasst_tpu_torch.utils.precision import highest_precision

__all__ = [
    "tf_covariance_features", "consensus_votes", "mixing_from_votes",
    "activity_profiles", "full_rank_init", "apply_profiles",
    "repair_votes", "candidate_votes", "select_init_by_likelihood",
    "band_em_votes", "glue_band_perms",
]

def tf_covariance_features(X: np.ndarray):
    """(F, N, I) complex STFT -> (feat, w, pw, xx).

    feat (F, N, I*I): power-normalized covariance entries (scale-invariant
    spatial signature; I diagonal powers then Re/Im of each upper
    off-diagonal); w (F, N): per-frame-normalized power weights;
    pw (F, N): bin power; xx (F, N, I, I): rank-1 bin covariances.
    The I == 2 path is kept verbatim (bit-identical features to the
    measured stereo pipeline); I != 2 takes the general construction.
    """
    I = X.shape[-1]
    if I == 2:
        p0 = np.abs(X[..., 0]) ** 2
        p1 = np.abs(X[..., 1]) ** 2
        cr = X[..., 0] * np.conj(X[..., 1])
        pw = p0 + p1
        feat = np.stack([p0, p1, cr.real, cr.imag], -1) \
            / np.maximum(pw, 1e-20)[..., None]
        w = pw / np.maximum(pw.mean(axis=1, keepdims=True), 1e-20)
        xx = np.stack([np.stack([p0, cr], -1),
                       np.stack([np.conj(cr), p1], -1)], -2)
        return feat, w, pw, xx
    xx = X[..., :, None] * np.conj(X[..., None, :])       # (F, N, I, I)
    pw = np.einsum('...ii->...', xx).real
    cols = [xx[..., i, i].real for i in range(I)]
    for i in range(I):
        for k in range(i + 1, I):
            cols.append(xx[..., i, k].real)
            cols.append(xx[..., i, k].imag)
    feat = np.stack(cols, -1) / np.maximum(pw, 1e-20)[..., None]
    w = pw / np.maximum(pw.mean(axis=1, keepdims=True), 1e-20)
    return feat, w, pw, xx


def _perm_tables(J: int):
    """All J! permutations (P, J) and their inverses (argsort rows)."""
    P = np.array(list(permutations(range(J))), dtype=np.int64)
    return P, np.argsort(P, axis=1)


def _best_assignment(S: np.ndarray) -> np.ndarray:
    """Per-frequency assignment maximizing sum_j S[f, sel[f, j], j].

    S (F, J, J). Enumerates the J! permutations for J <= 6 (vectorized);
    falls back to the Hungarian algorithm per frequency above that.
    Returns sel (F, J) with row f a permutation of range(J).
    """
    F, J, _ = S.shape
    if J <= 6:
        P, _ = _perm_tables(J)
        scores = S[:, P, np.arange(J)].sum(-1)          # (F, J!)
        return P[np.argmax(scores, axis=1)]
    from scipy.optimize import linear_sum_assignment
    sel = np.empty((F, J), np.int64)
    for f in range(F):
        rows, cols = linear_sum_assignment(-S[f])
        sel[f, cols] = rows
    return sel


def _normrows(a: np.ndarray) -> np.ndarray:
    a = a - a.mean(-1, keepdims=True)
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)


def _cluster_per_frequency(feat, w, J: int, seed: int,
                           kiter: int = 30, n_warm: int = 8000):
    """Warm-started per-frequency weighted k-means -> labels (F, N)."""
    F, N = feat.shape[:2]
    rng = np.random.default_rng(seed)
    zs = feat.reshape(-1, feat.shape[-1])
    ws = w.reshape(-1)
    sel = rng.choice(len(zs), min(n_warm, len(zs)), replace=False)
    zc, wc = zs[sel], ws[sel]
    C = zc[rng.choice(len(zc), J, replace=False)]
    for _ in range(25):                         # global warm-start k-means
        d2 = ((zc[:, None, :] - C[None]) ** 2).sum(-1)
        lab = d2.argmin(1)
        for j in range(J):
            m = lab == j
            if m.any():
                C[j] = np.average(zc[m], axis=0, weights=wc[m])
    Cf = np.tile(C[None], (F, 1, 1))            # per-frequency refinement
    lab = np.zeros((F, N), np.int64)
    for _ in range(kiter):
        d2 = ((feat[:, :, None, :] - Cf[:, None, :, :]) ** 2).sum(-1)
        lab = d2.argmin(-1)
        onehot = np.eye(J)[lab]
        wm = onehot * w[..., None]
        denom = wm.sum(1)                                        # (F, J)
        num = np.einsum('fnj,fnd->fjd', wm, feat)
        Cf = np.where(denom[..., None] > 1e-8,
                      num / np.maximum(denom, 1e-8)[..., None], Cf)
    return lab


# The node count above which the alignment graph is built and embedded on
# the device (_embed_nodes_device); at or below it the host path runs a
# dense eigh. configs[2] (F = 513, J = 4) is exactly 2052 nodes, so it
# takes the host path, bit for bit the JAX package's. Module state, as in
# the JAX package, so a caller can force either path.
_EMBED_DEVICE_MIN_NODES = 2052

# Node-envelope transform entering the alignment affinity graph:
#   log1p  log of mean-normalized activity (the default; every configs[2]
#          figure of the JAX package was measured with it)
#   rank   per-node rank transform (Spearman correlation of envelopes),
#          which the JAX package measured better on sparse, switching
#          envelopes (speech syllables, beat-locked stems)
# Module state (like _EMBED_DEVICE_MIN_NODES); `env_transform=` threads a
# choice through the public entry points.
_ENV_TRANSFORM = "log1p"


def _env_envelope(a, transform: Optional[str] = None):
    """Apply the configured envelope transform to mean-normalized
    activity `a` (host path). See _ENV_TRANSFORM."""
    tr = _ENV_TRANSFORM if transform is None else transform
    if tr == "log1p":
        return np.log1p(a)
    if tr == "rank":
        return np.argsort(np.argsort(a, axis=-1),
                          axis=-1).astype(np.float64)
    raise ValueError(f"unknown env transform: {tr!r}")


def _embed_nodes(act, pw, pweight: bool = True,
                 env_transform: Optional[str] = None,
                 device=DEFAULT_DEVICE):
    """(F, J, N) per-(frequency, cluster) activity -> eigen-embedding.

    Builds the envelope-correlation affinity graph over the F*J nodes
    (within-frequency edges removed -- those J nodes are distinct sources
    by construction; power-scaled so loud nodes anchor the partition) and
    returns (U (F*J, J): row-normalized top-J normalized-Laplacian
    eigenvectors, npow (F*J,): node powers).

    F*J <= _EMBED_DEVICE_MIN_NODES runs the host NumPy path (dense eigh),
    the JAX package's bits; above it the graph build and a Lanczos run on
    `device` (_embed_nodes_device): the music grids (F = 1025 or 4097) have
    thousands of nodes, where one dense host eigh per seed is slow.
    """
    F, J, N = act.shape
    npow = act.sum(-1).reshape(F * J)
    if F * J > _EMBED_DEVICE_MIN_NODES:
        U = _embed_nodes_device(act, pweight, env_transform, device=device)
        return U, npow
    E = _normrows(_env_envelope(
        act / np.maximum(act.mean(-1, keepdims=True), 1e-20),
        env_transform))
    nodes = E.reshape(F * J, N)
    W = np.maximum(nodes @ nodes.T, 0.0)
    idx = np.arange(F * J).reshape(F, J)
    for f in range(F):
        W[np.ix_(idx[f], idx[f])] = 0.0
    if pweight:
        sw = np.sqrt(npow / max(npow.mean(), 1e-20))
        W = W * np.minimum(sw[:, None], 3) * np.minimum(sw[None, :], 3)
    d = W.sum(1) + 1e-9
    Dm = 1.0 / np.sqrt(d)
    L = Dm[:, None] * W * Dm[None, :]
    _, vecs = np.linalg.eigh(L)
    U = vecs[:, -J:]
    return (U / np.maximum(np.linalg.norm(U, axis=1, keepdims=True),
                           1e-12), npow)


@highest_precision
def _lanczos_top(L: torch.Tensor, k: int, m: int = 64) -> torch.Tensor:
    """Top-k eigenvectors of a symmetric (n, n) tensor by m-step Lanczos
    with full reorthogonalization (twice per step, for float32), on L's
    device; the (m, m) tridiagonal eigh is negligible. Deterministic start
    vector. Columns ordered ASCENDING by eigenvalue, matching
    np.linalg.eigh's vecs[:, -k:] convention."""
    n = L.shape[0]
    m = min(m, n)
    # deterministic, dense start: cheap pseudo-random signs keep it
    # non-orthogonal to any particular eigenvector
    i = torch.arange(n, dtype=torch.float32, device=L.device)
    q0 = torch.sin(0.7 * i + 0.31) + 0.01
    q0 = (q0 / torch.linalg.norm(q0)).to(L.dtype)
    Q = torch.zeros((m, n), dtype=L.dtype, device=L.device)
    Q[0] = q0
    alphas = torch.zeros((m,), dtype=L.dtype, device=L.device)
    betas = torch.zeros((m,), dtype=L.dtype, device=L.device)
    for j in range(m):
        q = Q[j]
        z = L @ q
        a = torch.dot(q, z)
        z = z - a * q
        # full reorthogonalization against every previous vector (rows
        # past j are zero, so the mask is implicit), twice
        z = z - Q.T @ (Q @ z)
        z = z - Q.T @ (Q @ z)
        b = torch.linalg.norm(z)
        if j + 1 < m:
            Q[j + 1] = z / torch.clamp(b, min=1e-20)
        alphas[j] = a
        betas[j] = b
    T = (torch.diag(alphas) + torch.diag(betas[:m - 1], 1)
         + torch.diag(betas[:m - 1], -1))
    _, S = torch.linalg.eigh(T)                  # ascending
    return Q.T @ S[:, -k:]                       # Ritz vectors (n, k)


@highest_precision
def _embed_nodes_device(act, pweight: bool = True,
                        env_transform: Optional[str] = None,
                        device=DEFAULT_DEVICE):
    """Graph build + Lanczos of `_embed_nodes` on `device`, in float32
    with TF32 off (the embedding feeds assignment decisions). Returns the
    row-normalized (F*J, J) embedding on the host."""
    dev = resolve_device(device)
    F, J, N = act.shape
    n = F * J
    tr = _ENV_TRANSFORM if env_transform is None else env_transform
    act_t = torch.as_tensor(np.asarray(act), dtype=torch.float32,
                            device=dev)
    a = act_t / torch.clamp(act_t.mean(-1, keepdim=True), min=1e-20)
    if tr == "log1p":
        E = torch.log1p(a)
    elif tr == "rank":
        E = torch.argsort(torch.argsort(a, dim=-1, stable=True), dim=-1,
                          stable=True).to(torch.float32)
    else:
        raise ValueError(f"unknown env transform: {tr!r}")
    E = E - E.mean(-1, keepdim=True)
    E = E / torch.clamp(torch.linalg.norm(E, dim=-1, keepdim=True),
                        min=1e-12)
    nodes = E.reshape(n, N)
    W = torch.clamp(nodes @ nodes.T, min=0.0)
    fidx = torch.arange(n, device=dev) // J
    W = torch.where(fidx[:, None] == fidx[None, :], 0.0, W)
    if pweight:
        npow = act_t.sum(-1).reshape(n)
        sw = torch.sqrt(npow / torch.clamp(npow.mean(), min=1e-20))
        sw = torch.clamp(sw, max=3.0)
        W = W * sw[:, None] * sw[None, :]
    d = W.sum(1) + 1e-9
    Dm = 1.0 / torch.sqrt(d)
    L = Dm[:, None] * W * Dm[None, :]
    U = _lanczos_top(L, J).cpu().numpy()
    return U / np.maximum(np.linalg.norm(U, axis=1, keepdims=True), 1e-12)


def _spherical_kmeans(U, npow, J: int, seed: int = 0, iters: int = 25):
    """Power-weighted spherical k-means on embedding rows -> (J, dim)."""
    rng = np.random.default_rng(seed)
    wts = npow / max(npow.sum(), 1e-20)
    cent = U[rng.choice(len(U), J, replace=False, p=wts)]
    for _ in range(iters):
        a = np.argmax(U @ cent.T, 1)
        for k in range(J):
            m = a == k
            if m.any():
                c = np.average(U[m], axis=0, weights=npow[m] + 1e-12)
                cent[k] = c / max(np.linalg.norm(c), 1e-12)
    return cent


def _assignment_from_embedding(U, cent, F: int, J: int):
    """Per-frequency best assignment of that frequency's J nodes to the J
    communities -> sel (F, J)."""
    S = (U @ cent.T).reshape(F, J, J)
    return _best_assignment(S)


def _align_spectral(lab, pw, J: int, pweight: bool = True, seed: int = 0,
                    env_transform: Optional[str] = None,
                    device=DEFAULT_DEVICE):
    """Per-frequency permutation alignment by SPECTRAL CLUSTERING of the
    (frequency, cluster) activity-envelope correlation graph.

    Each (f, j) cluster is a node with a normalized log activity envelope
    (over frames); affinity = thresholded envelope correlation.
    Normalized-Laplacian eigenvectors (top J) + power-weighted spherical
    k-means give a soft community score per node; the per-frequency
    permutation is the best assignment of that frequency's J nodes to the
    J communities. Transitive envelope-correlation chains connect
    narrowband regions to their source without one global template (the
    JAX package measured +4..+6 dB min SDR over `_align_by_activity`'s
    mean-field anchor on its configs[2] family).
    """
    F, N = lab.shape
    oh = np.eye(J)[lab]
    act = np.einsum('fnj,fn->fjn', oh, pw)
    U, npow = _embed_nodes(act, pw, pweight, env_transform, device=device)
    cent = _spherical_kmeans(U, npow, J, seed=seed)
    sel = _assignment_from_embedding(U, cent, F, J)
    inv = np.argsort(sel, axis=1)
    return np.take_along_axis(inv, lab, axis=1)


def realign_votes(votes: np.ndarray, pw: np.ndarray, J: int,
                  seed: int = 0,
                  env_transform: Optional[str] = None,
                  device=DEFAULT_DEVICE) -> np.ndarray:
    """One more spectral-alignment pass over SOFT consensus votes.

    Re-embeds the per-(frequency, source) soft vote activity (instead of a
    hard label plane) and re-permutes the votes per frequency. A different
    estimate, not a refinement: it enters the candidate pool for
    model-evidence selection rather than replacing the per-seed path.
    """
    act = np.einsum('fnj,fn->fjn', votes, pw)
    F = pw.shape[0]
    U, npow = _embed_nodes(act, pw, env_transform=env_transform,
                           device=device)
    cent = _spherical_kmeans(U, npow, J, seed=seed)
    sel = _assignment_from_embedding(U, cent, F, J)
    return np.take_along_axis(votes, sel[:, None, :], axis=2)


def _align_by_activity(lab, pw, J: int, sweeps: int = 6):
    """Resolve the per-frequency cluster-order ambiguity.

    Correlates each frequency's per-cluster log-activity envelope (over
    frames) with the global mean envelope and permutes clusters to the
    best assignment; the global envelope re-forms after each sweep.
    """
    F, N = lab.shape
    oh = np.eye(J)[lab]
    act = np.einsum('fnj,fn->fjn', oh, pw)
    A_n = _normrows(np.log1p(
        act / np.maximum(act.mean(-1, keepdims=True), 1e-20)))
    g = A_n.mean(0)
    for _ in range(sweeps):
        g_n = _normrows(g)
        S = np.einsum('fjn,kn->fjk', A_n, g_n)           # (F, J, J)
        sel = _best_assignment(S)                        # (F, J)
        A_n = np.take_along_axis(A_n, sel[:, :, None], axis=1)
        inv = np.argsort(sel, axis=1)
        lab = np.take_along_axis(inv, lab, axis=1)
        g = A_n.mean(0)
    return lab


def _vote_consensus(labs, pw, J: int, rounds: int = 2) -> np.ndarray:
    """Permutation-match each seed's labels to a power-weighted consensus
    and average; `rounds` re-vote passes de-bias the seed-0 start."""
    cons = np.eye(J)[labs[0]] * pw[..., None]
    votes = np.zeros(pw.shape + (J,))
    for _ in range(rounds):
        votes = np.zeros(pw.shape + (J,))
        for L in labs:
            oh = np.eye(J)[L]
            T = np.einsum('fna,fnb->fab', oh, cons)
            sel = _best_assignment(T)
            votes += np.take_along_axis(oh, sel[:, None, :], axis=2)
        cons = votes * pw[..., None]
    return votes / len(labs)


def consensus_votes(X: np.ndarray, J: int, n_seeds: int = 8,
                    kiter: int = 30, rounds: int = 2,
                    backend: str = "device",
                    align: str = "spectral",
                    env_transform: Optional[str] = None,
                    device=DEFAULT_DEVICE) -> np.ndarray:
    """Soft source-dominance votes (F, N, J) from n_seeds clusterings.

    Each seed clusters and permutation-aligns independently; votes are then
    permutation-matched to a power-weighted consensus and averaged, with
    `rounds` re-vote passes (the first pass's consensus is seed-0 biased).

    align='spectral' (default) resolves each seed's per-frequency cluster
    order by spectral clustering of the envelope-correlation graph
    (`_align_spectral`); 'activity' is the older mean-field anchor; 'none'
    trusts the warm-started k-means' own cross-frequency consistency.

    backend='device' runs the clustering of all seeds as one batched
    k-means on `device` (the JAX package's backend 'jax'); for 'spectral'
    the alignment itself stays on the host (one eigendecomposition per
    seed). backend='numpy' is the loop-free host reference (and the only
    path for J > 6, where the permutation enumeration would not fit).
    """
    feat, w, pw, _ = tf_covariance_features(X)
    F, N = pw.shape
    if align in ("spectral", "none"):
        if backend == "device" and J <= 6:
            labs_all = _cluster_labels_device(feat, w, J, n_seeds, kiter,
                                              device=device)
            labs = [labs_all[s] for s in range(n_seeds)]
        else:
            labs = [_cluster_per_frequency(feat, w, J, seed=s, kiter=kiter)
                    for s in range(n_seeds)]
        if align == "spectral":
            labs = [_align_spectral(L, pw, J, env_transform=env_transform,
                                    device=device)
                    for L in labs]
        return _vote_consensus(labs, pw, J, rounds)
    if backend == "device" and J <= 6:
        return _consensus_votes_device(feat, w, pw, J, n_seeds, kiter,
                                       rounds, device=device)
    labs = [_align_by_activity(
        _cluster_per_frequency(feat, w, J, seed=s, kiter=kiter), pw, J)
        for s in range(n_seeds)]
    return _vote_consensus(labs, pw, J, rounds)


# -- the device backend -------------------------------------------------------

def _prep_seeds(feat, w, n_seeds: int, J: int, M: int = 8000,
                device=DEFAULT_DEVICE):
    """Per-seed warm-start subsamples and initial centroids (host RNG, the
    JAX package's draws), as float32 tensors on `device`."""
    zs = feat.reshape(-1, feat.shape[-1]).astype(np.float32)
    ws = w.reshape(-1).astype(np.float32)
    zc, wc, C0 = [], [], []
    for s in range(n_seeds):
        rng = np.random.default_rng(s)
        sel = rng.choice(len(zs), min(M, len(zs)), replace=False)
        zc.append(zs[sel])
        wc.append(ws[sel])
        C0.append(zc[-1][rng.choice(len(sel), J, replace=False)])
    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.stack(a), device=dev)
                 for a in (zc, wc, C0))      # (S, M, D), (S, M), (S, J, D)


def _labels_from_centroids(feat2, C):
    """argmin_j |feat - C_j|^2 through the expansion |C_j|^2 - 2 feat.C_j
    (|feat|^2 is the same for every j); feat2 (..., N, D), C (..., J, D)."""
    d = (torch.sum(C * C, -1)[..., None, :]
         - 2.0 * (feat2 @ C.transpose(-1, -2)))
    return torch.argmin(d, dim=-1)


def _kmeans_labels(feat, w, zc, wc, C0, J: int, kiter: int):
    """Warm-started per-frequency weighted k-means of all seeds at once:
    feat (F, N, D), w (F, N), zc (S, M, D), wc (S, M), C0 (S, J, D) ->
    labels (S, F, N). Same iteration as the host path
    (_cluster_per_frequency)."""
    S = zc.shape[0]
    F, N = feat.shape[:2]
    eye = torch.eye(J, dtype=feat.dtype, device=feat.device)
    C = C0
    for _ in range(25):
        lab = _labels_from_centroids(zc, C)            # (S, M)
        oh = eye[lab] * wc[..., None]                  # (S, M, J)
        den = oh.sum(1)                                # (S, J)
        num = oh.transpose(1, 2) @ zc                  # (S, J, D)
        C = torch.where(den[..., None] > 1e-8,
                        num / torch.clamp(den, min=1e-8)[..., None], C)
    Cf = C[:, None].expand(S, F, J, C.shape[-1])
    wf = w[None, ..., None]                            # (1, F, N, 1)
    for _ in range(kiter):
        lab = _labels_from_centroids(feat[None], Cf)   # (S, F, N)
        oh = eye[lab] * wf                             # (S, F, N, J)
        den = oh.sum(2)                                # (S, F, J)
        num = oh.transpose(-1, -2) @ feat              # (S, F, J, D)
        Cf = torch.where(den[..., None] > 1e-8,
                         num / torch.clamp(den, min=1e-8)[..., None], Cf)
    return _labels_from_centroids(feat[None], Cf)      # (S, F, N)


@highest_precision
def _cluster_labels_device(feat, w, J: int, n_seeds: int, kiter: int,
                           device=DEFAULT_DEVICE) -> np.ndarray:
    """All n_seeds warm-started per-frequency k-means label planes, batched
    on `device` -> (S, F, N) int64 labels on the host. The spectral
    alignment (host, `_align_spectral`) consumes them.

    TF32 stays off: the distance expansion is cancellation-sensitive, and
    the JAX package measured reduced-precision products flipping labels
    between near centroids on its configs[2] fixtures (a different and
    worse candidate landscape: 13 of 16 hypotheses degenerate against 8).
    """
    zc, wc, C0 = _prep_seeds(feat, w, n_seeds, J, device=device)
    dev = zc.device
    lab = _kmeans_labels(
        torch.as_tensor(feat, dtype=torch.float32, device=dev),
        torch.as_tensor(w, dtype=torch.float32, device=dev), zc, wc, C0,
        J, kiter)
    return lab.cpu().numpy()


def _consensus_kernel(feat, w, pw, zc, wc, C0, J: int, kiter: int,
                      rounds: int):
    """k-means, activity alignment and consensus voting of all seeds on
    the device (the align='activity' path): votes (F, N, J)."""
    S = zc.shape[0]
    F, N = pw.shape
    dev = feat.device
    eye = torch.eye(J, dtype=torch.float32, device=dev)
    P = torch.as_tensor(_perm_tables(J)[0], device=dev)    # (J!, J)
    ar = torch.arange(J, device=dev)

    lab = _kmeans_labels(feat, w, zc, wc, C0, J, kiter)

    def normrows(a):
        a = a - a.mean(-1, keepdim=True)
        return a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                               min=1e-12)

    act = eye[lab].permute(0, 1, 3, 2) * pw[None, :, None, :]  # (S,F,J,N)
    A_n = normrows(torch.log1p(
        act / torch.clamp(act.mean(-1, keepdim=True), min=1e-20)))
    g = A_n.mean(1)                                    # (S, J, N)
    for _ in range(6):
        g_n = normrows(g)
        Sm = A_n @ g_n[:, None].transpose(-1, -2)      # (S, F, J, J)
        scores = Sm[:, :, P, ar].sum(-1)               # (S, F, J!)
        sel = P[torch.argmax(scores, dim=-1)]          # (S, F, J)
        A_n = torch.gather(A_n, 2, sel[..., None].expand(-1, -1, -1, N))
        inv = torch.argsort(sel, dim=-1)
        lab = torch.gather(inv, -1, lab)
        g = A_n.mean(1)

    oh = eye[lab]                                      # (S, F, N, J)
    cons = oh[0] * pw[..., None]                       # (F, N, J)
    votes = torch.zeros((F, N, J), dtype=torch.float32, device=dev)
    for _ in range(rounds):
        T = oh.transpose(-1, -2) @ cons                # (S, F, J, J)
        scores = T[:, :, P, ar].sum(-1)
        sel = P[torch.argmax(scores, dim=-1)]          # (S, F, J)
        oh_p = torch.gather(oh, -1, sel[:, :, None, :].expand(-1, -1, N,
                                                              -1))
        votes = oh_p.sum(0)
        cons = votes * pw[..., None]
    return votes / S


@highest_precision
def _consensus_votes_device(feat, w, pw, J: int, n_seeds: int, kiter: int,
                            rounds: int, device=DEFAULT_DEVICE
                            ) -> np.ndarray:
    """The whole align='activity' pipeline of all seeds on `device`; only
    the warm-start subsampling stays on the host. Differs from the NumPy
    path only at argmin/argmax ties."""
    zc, wc, C0 = _prep_seeds(feat, w, n_seeds, J, device=device)
    dev = zc.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    votes = _consensus_kernel(t(feat), t(w), t(pw), zc, wc, C0, J=J,
                              kiter=kiter, rounds=rounds)
    return votes.cpu().numpy().astype(np.float64)


# -- mixing, candidates, repairs ----------------------------------------------

def mixing_from_votes(votes: np.ndarray, xx: np.ndarray, pw: np.ndarray,
                      rank: int = 2) -> np.ndarray:
    """Vote-weighted full-rank covariances -> (J, F, I, rank) mixing columns.

    R_j(f) = sum_n votes * pw * x x^H / sum_n votes * pw, trace-normalized
    to I; the mixing columns are eigenvectors scaled by sqrt(eigenvalues)
    (descending), i.e. R_j = A_j A_j^H exactly at rank = I.
    """
    wv = votes * pw[..., None]
    Rj = np.einsum('fnj,fnab->jfab', wv, xx) / np.maximum(
        wv.sum(1).T[:, :, None, None], 1e-6)
    tr = np.trace(Rj, axis1=2, axis2=3).real
    Rj = Rj / np.maximum(tr[..., None, None], 1e-12) * float(xx.shape[-1])
    lam, V = np.linalg.eigh(Rj)                      # ascending
    lam = np.maximum(lam[..., ::-1], 1e-10)          # descending
    V = V[..., ::-1]
    return (V * np.sqrt(lam)[..., None, :])[..., :rank]


def _nmf_shares(M: np.ndarray, r: int, iters: int = 80, seed: int = 0,
                eps: float = 1e-12, inner_rank: int = 1):
    """Rank-r KL-NMF split of a masked power plane M (F, N).

    inner_rank atoms per component (the JAX package measured inner_rank=1
    splitting cleanest on its configs[2] family). Returns (shares
    (F, N, r): soft per-bin fraction of each component, H (r, N):
    per-component temporal activations, summed over inner atoms)."""
    rng = np.random.default_rng(seed)
    F, N = M.shape
    K = r * inner_rank
    W = 0.5 + rng.random((F, K))
    H = 0.5 + rng.random((K, N))
    for _ in range(iters):
        V = W @ H + eps
        W *= ((M / V) @ H.T) / np.maximum(H.sum(1)[None], eps)
        V = W @ H + eps
        H *= (W.T @ (M / V)) / np.maximum(W.sum(0)[:, None], eps)
    P = np.stack([W[:, i::r] @ H[i::r] for i in range(r)], -1) \
        if inner_rank > 1 else np.stack(
            [W[:, i:i + 1] * H[i:i + 1] for i in range(r)], -1)
    # interleaved atom grouping (i::r) keeps init symmetry across comps
    shares = P / np.maximum(P.sum(-1, keepdims=True), eps)
    Hc = np.stack([H[i::r].sum(0) for i in range(r)])
    return shares, Hc


def _nmf_split(M: np.ndarray, iters: int = 80, seed: int = 0,
               eps: float = 1e-12):
    """Rank-2 KL-NMF of a masked power plane M (F, N).

    Returns (share (F, N): soft fraction of component 0 per bin,
    H (2, N): the two temporal activations)."""
    shares, H = _nmf_shares(M, 2, iters=iters, seed=seed, eps=eps,
                            inner_rank=1)
    return shares[..., 0], H


def _merge_split(votes: np.ndarray, pw: np.ndarray, i: int, k: int, c: int,
                 min_balance: float = 0.05, max_hcorr: float = 0.9):
    """One structural repair hypothesis: merge clusters (i, k), then split
    cluster c (c != k; c == i splits the merged cluster) by rank-2 KL-NMF
    of its masked power plane. Returns (votes', hcorr, balance) or None if
    the split is unacceptable (too unbalanced, or the two NMF activations
    are near-copies -- halves of one source, not two sources)."""
    J = votes.shape[-1]
    assert i != k and c != k and 0 <= min(i, k, c) < max(i, k, c) < J
    merged = votes[..., i] + votes[..., k]
    Mc = (merged if c == i else votes[..., c]) * pw
    share, H = _nmf_split(Mc)
    # CENTERED correlation of the two activations: nonnegative activations
    # share a large DC component, so the raw cosine is ~0.9 even for
    # unrelated envelopes and would invert the ranking.
    h = H - H.mean(axis=1, keepdims=True)
    h /= np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-12)
    hcorr = abs(float((h[0] * h[1]).sum()))
    p0 = float((share * Mc).sum())
    p1 = float(((1.0 - share) * Mc).sum())
    bal = min(p0, p1) / max(p0 + p1, 1e-12)
    if bal < min_balance or hcorr > max_hcorr:
        return None
    out = votes.copy()
    out[..., i] = merged
    src = merged if c == i else votes[..., c]
    out[..., k] = src * (1.0 - share)
    out[..., c] = src * share
    return out, hcorr, bal


def _compositions(J: int, D: int):
    """All ways to allocate J sources over D direction groups, each >= 1."""
    if D == 1:
        yield (J,)
        return
    for first in range(1, J - D + 2):
        for rest in _compositions(J - first, D - 1):
            yield (first,) + rest


def direction_split_candidates(X: np.ndarray, J: int, pw: np.ndarray,
                               n_seeds: int = 8, kiter: int = 30,
                               backend: str = "device", max_alloc: int = 8,
                               n_nmf_seeds: int = 3,
                               device=DEFAULT_DEVICE):
    """Direction-first repair hypotheses for same-direction mixtures.

    When several sources share a mixing direction (J sources over D < J
    distinct positions), J-way spatial clustering cannot produce
    per-source clusters. This clusters the spatial features into D < J
    DIRECTION groups, then splits each group's masked power plane into its
    allocated number of sources by rank-k KL-NMF. Every allocation of J
    over D groups (each >= 1) yields one candidate vote array, e.g. J=4,
    D=2 -> (1,3), (2,2), (3,1), each allocation that splits a group under
    `n_nmf_seeds` split seeds. The caller disambiguates by model evidence.
    """
    cands = []
    for D in range(2, J):
        dvotes = consensus_votes(X, D, n_seeds=n_seeds, kiter=kiter,
                                 backend=backend, device=device)
        allocs = list(_compositions(J, D))[:max_alloc]
        for alloc in allocs:
            seeds = range(n_nmf_seeds) if any(k > 1 for k in alloc) \
                else range(1)
            for s in seeds:
                v = np.empty(pw.shape + (J,))
                j0 = 0
                for d, k in enumerate(alloc):
                    if k == 1:
                        v[..., j0] = dvotes[..., d]
                    else:
                        shares, _ = _nmf_shares(dvotes[..., d] * pw, k,
                                                seed=s)
                        v[..., j0:j0 + k] = dvotes[..., d, None] * shares
                    j0 += k
                name = f"dirs{D}+alloc{alloc}" + \
                    (f"#s{s}" if len(list(seeds)) > 1 else "")
                cands.append((name, v))
    return cands


def candidate_votes(votes: np.ndarray, pw: np.ndarray,
                    corr_floor: float = 0.25, max_pairs: int = 3):
    """Enumerate structural repair hypotheses of the blind clustering.

    For each of the `max_pairs` most-envelope-correlated cluster pairs
    (above `corr_floor`; every pair when J <= 4) and every acceptable split
    target, emit the merge+split vote array. Always includes the
    unrepaired votes first ("raw"). The caller disambiguates by model
    evidence rather than by heuristic.
    """
    J = votes.shape[-1]
    cands = [("raw", votes)]
    wv = votes * pw[..., None]
    a = np.einsum('fnj->jn', wv)
    an = a - a.mean(-1, keepdims=True)
    an /= np.maximum(np.linalg.norm(an, axis=-1, keepdims=True), 1e-12)
    corr = an @ an.T
    iu = np.triu_indices(J, 1)
    order = np.argsort(-corr[iu])
    # at small J the pool is cheap and the correlation ranking of WHICH
    # pair is merged can be wrong: enumerate every pair
    if J <= 4:
        max_pairs, corr_floor = len(iu[0]), -1.0
    for r in order[:max_pairs]:
        i, k = int(iu[0][r]), int(iu[1][r])
        if corr[i, k] < corr_floor:
            break
        for c in range(J):
            if c == k:
                continue
            res = _merge_split(votes, pw, i, k, c)
            if res is not None:
                cands.append((f"merge({i},{k})+split({c})", res[0]))
    return cands


# -- blind degeneracy statistics, over a batch of runs ------------------------

@highest_precision
def _max_env_corr(Y: torch.Tensor) -> torch.Tensor:
    """Max pairwise centered correlation of per-source log power envelopes,
    per run: Y (C, J, F, N, I) complex separated spectra -> (C,).

    Two estimated sources that are really HALVES OF ONE source switch on
    and off together -> their envelopes correlate near 1; distinct sources
    do not. The blind degeneracy signal that vetoes a run.
    """
    e = torch.sum(Y.abs() ** 2, dim=(2, 4))                   # (C, J, N)
    e = torch.log1p(e / torch.clamp(e.mean(-1, keepdim=True), min=1e-20))
    e = e - e.mean(-1, keepdim=True)
    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                        min=1e-12)
    eye = torch.eye(e.shape[1], dtype=e.dtype, device=e.device)
    C = e @ e.transpose(-1, -2) - 2.0 * eye
    return C.flatten(1).max(-1).values


def _min_band_coherence(Y: torch.Tensor, n_bands: int = 8,
                        min_bands: float = 1.5) -> torch.Tensor:
    """Min over SCOREABLE stems of the power-weighted mean cross-band
    envelope correlation -- a blind frequency-interleaving detector, per
    run: Y (C, J, F, N, I) -> (C,).

    A real source's bands co-modulate; a stem assembled from per-frequency
    permutation errors interleaves different sources across bands, whose
    band envelopes do not correlate. Stems whose band power participation
    ratio (sum w)^2 / sum w^2 is below `min_bands` (narrowband stems) are
    exempt; with every stem exempt the result is 1.
    """
    coh, pr = _band_coherence_stats(Y, n_bands)
    return torch.where(pr >= min_bands, coh, 1.0).min(-1).values


@highest_precision
def _band_coherence_stats(Y: torch.Tensor, n_bands: int = 8):
    """Per run and stem (coherence (C, J), band participation ratio
    (C, J)); see `_min_band_coherence`."""
    Cn, J, F, N, I = Y.shape
    Fb = F - F % n_bands
    p = torch.sum(Y[:, :, :Fb].abs() ** 2, dim=4)             # (C,J,Fb,N)
    pb = p.reshape(Cn, J, n_bands, Fb // n_bands, N).sum(3)   # (C,J,B,N)
    w = pb.sum(-1)                                            # (C, J, B)
    e = torch.log1p(pb / torch.clamp(pb.mean(-1, keepdim=True),
                                     min=1e-20))
    e = e - e.mean(-1, keepdim=True)
    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                        min=1e-12)
    Cm = e @ e.transpose(-1, -2)                              # (C,J,B,B)
    wgm = torch.sqrt(w[..., :, None] * w[..., None, :])
    off = 1.0 - torch.eye(n_bands, dtype=e.dtype, device=e.device)
    num = torch.sum(Cm * wgm * off, dim=(-2, -1))
    den = torch.clamp(torch.sum(wgm * off, dim=(-2, -1)), min=1e-20)
    pr = (w.sum(-1) ** 2) / torch.clamp((w ** 2).sum(-1), min=1e-20)
    return num / den, pr


# -- candidate runs on the device ---------------------------------------------

def _em_seed_spec(seed: int, J: int, F: int, N: int, nmf_comps: int,
                  dtype=torch.float32, device=DEFAULT_DEVICE):
    """The random spectral init of EM seed `seed`: source j's NMF
    component from the j-th key of split(PRNGKey(seed), J), the JAX
    package's draws (utils/prng.py). Returns a tuple of J SpectralComp
    (B = 1)."""
    from pyfasst_tpu_torch.models.components import init_nmf_comp
    from pyfasst_tpu_torch.utils import prng
    keys = prng.split(prng.PRNGKey(int(seed)), J)
    return tuple(init_nmf_comp(keys[j], F, N, nmf_comps, spat_ind=j,
                               dtype=dtype, device=device)
                 for j in range(J))


def _conv_spat(A: np.ndarray, dtype, device):
    """SpatialComp tuple of a (J, F, I, R) complex mixing array, B = 1."""
    from pyfasst_tpu_torch.models.components import CONV, SpatialComp
    return tuple(SpatialComp(A=torch.as_tensor(A[j][None], dtype=dtype,
                                               device=device),
                             mix_type=CONV) for j in range(A.shape[0]))


def _batched_runs(plist, xlist, cfg, mesh):
    """One batched GEM run (and its Wiener separation) over the clip axis
    on `mesh`: params (B = 1 each) and host planes (F, N, I) -> (logliks
    (C, niter), Y_b (C, J, F, N, I)). Each run's annealing endpoints come
    from its own plane. The batch is padded to a multiple of the mesh's dp
    axis with copies of the first run, dropped from the results."""
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints

    C = len(plist)
    pad = -C % mesh.dp
    X_b = torch.as_tensor(np.stack(xlist + [xlist[0]] * pad),
                          dtype=torch.complex64, device=mesh.device)
    sig = annealing_endpoints(X_b, cfg)
    params_b, lls = batched_run_gem(batch_params(plist + [plist[0]] * pad),
                                    X_b, cfg, mesh, sigma_endpoints_b=sig)
    Y_b = sharded_batch_separate(params_b, X_b, sig[1], mesh)
    return lls[:C], Y_b[:C]


def select_init_by_likelihood(X: np.ndarray, cands, xx, pw,
                              rank: int = 2, probe_iters: int = 60,
                              nmf_comps: int = 6, fs: int = 16000,
                              env_thr: float = 0.6,
                              verbose: bool = False, n_devices: int = 1,
                              device=DEFAULT_DEVICE):
    """Pick the repair hypothesis by vetoed model evidence.

    Each candidate vote array seeds a full-rank model (mixing + activity
    profiles); a short `probe_iters` GEM run scores it. Two blind stages:
    (1) VETO candidates whose probe separation contains a duplicated source
    (max pairwise stem-envelope correlation > `env_thr`); (2) among
    survivors, pick the max final probe log-likelihood. If nothing
    survives, warn and fall back to the lowest-correlation candidate.

    Returns (A_init, tw_prof, fb_prof, best_name). All probes run as ONE
    batched run_gem call and one separate_sources call over the clip axis
    on `device` (kernel 1 on the card), or on a mesh of n_devices ranks
    (parallel/sharding.py).
    """
    from pyfasst_tpu_torch.models.components import FasstParams
    from pyfasst_tpu_torch.utils.config import GEMConfig

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    J = cands[0][1].shape[-1]
    Xn = np.ascontiguousarray(X) / float(np.sqrt(np.mean(np.abs(X) ** 2)))
    cfg = GEMConfig(niter=probe_iters, spatial_hold_frac=0.3)
    F, N = X.shape[:2]
    spec = _em_seed_spec(0, J, F, N, nmf_comps, device=dev)

    inits, plist = [], []
    for name, v in cands:
        A = mixing_from_votes(v, xx, pw, rank=rank)
        twp, fbp = activity_profiles(v, pw)
        plist.append(apply_profiles(FasstParams(
            spat=_conv_spat(A, torch.complex64, dev), spec=spec), twp, fbp))
        inits.append((name, A, twp, fbp))
    lls, Y_b = _batched_runs(plist, [Xn] * len(plist), cfg, mesh)
    lls = lls[:, -1].cpu().numpy().astype(np.float64)
    ec = _max_env_corr(Y_b).cpu().numpy().astype(np.float64)
    ok = ec <= env_thr
    if verbose:
        for (name, *_), ll, e in zip(inits, lls, ec):
            print(f"select_init: {name}: probe ll {ll:.1f} envcorr {e:.3f}"
                  f"{'' if e <= env_thr else '  [vetoed]'}")
    if not ok.any():
        import warnings
        warnings.warn(
            "spatial_init: every repair hypothesis left a duplicated "
            f"source (min stem-envelope corr {ec.min():.2f} > "
            f"{env_thr}); the mixture may not support "
            f"{cands[0][1].shape[-1]} separable sources -- expect one "
            "duplicated/empty stem, or retry with fewer sources.",
            stacklevel=2)
        pick = int(np.argmin(ec))        # least-degenerate fallback
    else:
        lls_m = np.where(ok, lls, -np.inf)
        pick = int(np.argmax(lls_m))
    name, A, twp, fbp = inits[pick]
    return A, twp, fbp, name


class BandProbes(NamedTuple):
    """Converged band-local EM probe products (see _band_em_probes)."""
    starts: tuple          # band start bins (last band may overlap)
    Fb: int                # band width in bins
    pick: np.ndarray       # (B,) winning run index per band (by loglik)
    lab: np.ndarray        # (C, Fb, N) converged Wiener dominance labels
    env: np.ndarray        # (C, J, N) converged per-stem envelopes
    ll: np.ndarray         # (C,) final log-likelihoods
    names: tuple           # (band, em_seed) per run
    votes_init: np.ndarray  # (F, N, J) the init vote plane used
    feat: np.ndarray       # tf_covariance_features of the full plane
    w: np.ndarray
    pw: np.ndarray
    xx: np.ndarray


@highest_precision
def _band_em_probes(X: np.ndarray, J: int, *, band_width: int = 32,
                    iters: int = 150, nmf_comps: int = 3, rank: int = 2,
                    votes_init: Optional[np.ndarray] = None,
                    n_seeds: int = 8, em_seeds: int = 2,
                    env_transform: Optional[str] = None,
                    n_devices: int = 1, seed: int = 0,
                    verbose: bool = False,
                    device=DEFAULT_DEVICE) -> BandProbes:
    """Steps 1-3 of band_em_votes: a full GEM per frequency band (every
    (band, spectral-seed) run in one batched run over the clip axis on
    `device`), each band's seed picked by final log-likelihood; returns
    the converged dominance labels and envelopes for the alignment
    emitters (band_em_votes) and the gluing scorer (glue_band_perms)."""
    from pyfasst_tpu_torch.models.components import FasstParams
    from pyfasst_tpu_torch.utils.config import GEMConfig

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    F, N, I = X.shape
    feat, w, pw, xx = tf_covariance_features(X)
    if votes_init is None:
        votes_init = consensus_votes(X, J, n_seeds=n_seeds,
                                     env_transform=env_transform,
                                     device=dev)

    Fb = min(band_width, F)
    starts = list(range(0, F - Fb + 1, Fb))
    if starts[-1] + Fb < F:
        starts.append(F - Fb)
    B = len(starts)

    # per-(band, seed) params + per-band normalized spectra
    names, plist, xlist = [], [], []
    for bi, s0 in enumerate(starts):
        sl = slice(s0, s0 + Fb)
        vb, pwb, xxb = votes_init[sl], pw[sl], xx[sl]
        A = mixing_from_votes(vb, xxb, pwb, rank=rank)
        twp, fbp = activity_profiles(vb, pwb)
        scale = float(np.sqrt(np.mean(np.abs(X[sl]) ** 2))) or 1.0
        Xb = np.ascontiguousarray(X[sl]) / scale
        spat = _conv_spat(A, torch.complex64, dev)
        for es in range(em_seeds):
            spec = _em_seed_spec(seed + 1000 * es + bi, J, Fb, N, nmf_comps,
                                 device=dev)
            plist.append(apply_profiles(FasstParams(spat=spat, spec=spec),
                                        twp, fbp))
            xlist.append(Xb)
            names.append((bi, es))

    cfg = GEMConfig(niter=iters, spatial_hold_frac=0.3)
    lls, Y_b = _batched_runs(plist, xlist, cfg, mesh)
    p = torch.sum(Y_b.abs() ** 2, dim=4)               # (C, J, Fb, N)
    lab_b = torch.argmax(p, dim=1).cpu().numpy()       # (C, Fb, N)
    env_b = torch.sum(p, dim=2).cpu().numpy().astype(np.float64)
    ll = lls[:, -1].cpu().numpy().astype(np.float64)

    # per-band best spectral seed by final loglik
    pick = np.full(B, -1, np.int64)
    best = np.full(B, -np.inf)
    for i, (bi, es) in enumerate(names):
        if ll[i] > best[bi]:
            best[bi], pick[bi] = ll[i], i
    if verbose:
        print(f"band_em_votes: {B} bands x {em_seeds} seeds, "
              f"ll range {ll.min():.1f}..{ll.max():.1f}")
    return BandProbes(starts=tuple(starts), Fb=Fb, pick=pick, lab=lab_b,
                      env=env_b, ll=ll, names=tuple(names),
                      votes_init=votes_init, feat=feat, w=w, pw=pw, xx=xx)


def glue_band_perms(X: np.ndarray, J: int, probes: BandProbes, *,
                    glue_iters: int = 20, nmf_comps: int = 2,
                    rank: int = 2, fixed_spatial: bool = True,
                    n_devices: int = 1, seed: int = 0,
                    chunk: int = 128, verbose: bool = False,
                    device=DEFAULT_DEVICE):
    """MODEL-EVIDENCE pairwise band gluing.

    For each ADJACENT band pair (b, b+1) and each relative permutation rho
    of band b+1's converged stems against band b's, run a SHORT joint EM
    over the two-band slab, seeded from the glued dominance votes, and
    pick rho by final log-likelihood (every rho of a pair shares the
    pair's spectral seeds). fixed_spatial freezes the spatial components
    at the vote-derived mixing, so the likelihood moves only through the
    shared spectral factors. Runs go in chunks of `chunk` over the clip
    axis on `device`. The JAX package measured this family and rejected
    it as a quality lever (it never strictly beat the envelope or init
    alignment on its hard draws); kept for the catalogue, outside the
    production pool.

    Returns (perms, margins): perms (B-1, J) with perms[p][a] = stem of
    band p+1 glued to stem a of band p; margins (B-1,) the loglik gap
    between the winning rho and the runner-up.
    """
    from pyfasst_tpu_torch.models.components import (
        CONV, FasstParams, SpatialComp,
    )
    from pyfasst_tpu_torch.utils.config import GEMConfig

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    starts, Fb, pick = probes.starts, probes.Fb, probes.pick
    B = len(starts)
    pw, xx = probes.pw, probes.xx
    P, Pinv = _perm_tables(J)
    nP = len(P)

    plist, xlist = [], []
    for pi in range(B - 1):
        sl0 = slice(starts[pi], starts[pi] + Fb)
        sl1 = slice(starts[pi + 1], starts[pi + 1] + Fb)
        lab0 = probes.lab[pick[pi]]
        lab1 = probes.lab[pick[pi + 1]]
        Xs = np.concatenate([X[sl0], X[sl1]], axis=0)
        xxs = np.concatenate([xx[sl0], xx[sl1]], axis=0)
        pws = np.concatenate([pw[sl0], pw[sl1]], axis=0)
        scale = float(np.sqrt(np.mean(np.abs(Xs) ** 2))) or 1.0
        Xs = np.ascontiguousarray(Xs) / scale
        v0 = np.eye(J)[lab0]
        # same spectral seeds for every rho within a pair
        spec = _em_seed_spec(seed + pi, J, 2 * Fb, lab0.shape[1], nmf_comps,
                             device=dev)
        for ri in range(nP):
            v1 = np.eye(J)[Pinv[ri][lab1]]
            votes = np.concatenate([v0, v1], axis=0)       # (2Fb, N, J)
            A = mixing_from_votes(votes, xxs, pws, rank=rank)
            twp, fbp = activity_profiles(votes, pws)
            spat = tuple(SpatialComp(
                A=torch.as_tensor(A[j][None], dtype=torch.complex64,
                                  device=dev),
                mix_type=CONV, free=not fixed_spatial) for j in range(J))
            plist.append(apply_profiles(FasstParams(spat=spat, spec=spec),
                                        twp, fbp))
            xlist.append(Xs)

    cfg = GEMConfig(niter=glue_iters, spatial_hold_frac=0.3)
    nruns = len(plist)
    lls = np.full(nruns, -np.inf)
    for c0 in range(0, nruns, chunk):
        ll_b, _ = _batched_runs(plist[c0:c0 + chunk],
                                xlist[c0:c0 + chunk], cfg, mesh)
        lls[c0:c0 + chunk] = ll_b[:, -1].cpu().numpy().astype(np.float64)
    llm = lls.reshape(B - 1, nP)
    order = np.argsort(llm, axis=1)[:, ::-1]
    perms = P[order[:, 0]]
    margins = llm[np.arange(B - 1), order[:, 0]] \
        - llm[np.arange(B - 1), order[:, 1]]
    if verbose:
        print(f"glue_band_perms: {B - 1} pairs x {nP} perms, "
              f"margins {margins.min():.2f}..{margins.max():.2f}")
    return perms, margins


def _chain_glue(perms: np.ndarray, J: int) -> np.ndarray:
    """Compose pairwise gluings into a global band alignment.

    inv[b][a] = output channel of band b's stem a; band 0 anchors the
    channels, then inv[b+1][a'] = inv[b][rho^-1[a']] for each glued
    pair (one wrong link misaligns everything above it -- the margins
    say which links are weak)."""
    B = perms.shape[0] + 1
    inv = np.zeros((B, J), np.int64)
    inv[0] = np.arange(J)
    for b in range(B - 1):
        inv[b + 1] = inv[b][np.argsort(perms[b])]
    return inv


def band_em_votes(X: np.ndarray, J: int, *, band_width: int = 32,
                  iters: int = 150, nmf_comps: int = 3, rank: int = 2,
                  votes_init: Optional[np.ndarray] = None,
                  n_seeds: int = 8, em_seeds: int = 2,
                  env_transform: Optional[str] = None,
                  band_align: str = "envelope",
                  glue_iters: int = 20,
                  n_devices: int = 1, seed: int = 0,
                  probes: Optional[BandProbes] = None,
                  return_detail: bool = False,
                  verbose: bool = False, device=DEFAULT_DEVICE):
    """Per-bin votes from BAND-LOCAL EM probes (model-evidence pooling).

    1. Split F into `band_width`-bin bands (the last band overlaps to fit).
    2. Run a full GEM per band, every (band, spectral seed) run in one
       batched run on `device`, seeded from the consensus votes restricted
       to the band.
    3. Per band pick the spectral seed by final log-likelihood.
    4. Align the BANDS (B nodes instead of F) across frequency.
    5. Per-bin votes = the aligned bands' Wiener dominance one-hots
       (overlapped bins average).

    band_align picks step 4: 'envelope' (re-cluster the band nodes by
    their at-convergence envelopes), 'init' (permute each band's stems to
    agree with the band's own init votes), 'spatial' (band feature
    centroids; the JAX package measured and rejected it), 'glue'
    (glue_band_perms; measured and rejected), or 'both' / 'all' /
    'all+glue' for a dict {mode: votes} from the same probes.
    return_detail=True also returns {"probes", "inv"}; pass `probes` to
    reuse one probe set.
    """
    if probes is None:
        probes = _band_em_probes(
            X, J, band_width=band_width, iters=iters,
            nmf_comps=nmf_comps, rank=rank, votes_init=votes_init,
            n_seeds=n_seeds, em_seeds=em_seeds,
            env_transform=env_transform, n_devices=n_devices,
            seed=seed, verbose=verbose, device=device)
    F, N = X.shape[:2]
    starts, Fb, pick = probes.starts, probes.Fb, probes.pick
    lab_b, env_b = probes.lab, probes.env
    feat, pw, votes_init = probes.feat, probes.pw, probes.votes_init
    B = len(starts)

    def _emit(inv):
        votes = np.zeros((F, N, J))
        counts = np.zeros((F, 1, 1))
        for b, s0 in enumerate(starts):
            lab = inv[b][lab_b[pick[b]]]                 # (Fb, N)
            votes[s0:s0 + Fb] += np.eye(J)[lab]
            counts[s0:s0 + Fb] += 1.0
        return votes / counts

    out, invs = {}, {}
    if band_align in ("envelope", "both", "all", "all+glue"):
        act = np.stack([env_b[pick[b]] for b in range(B)])   # (B, J, N)
        pwb = np.stack([pw[s0:s0 + Fb].sum(0) for s0 in starts])
        U, npow = _embed_nodes(act, pwb, env_transform=env_transform,
                               device=device)
        cent = _spherical_kmeans(U, npow, J, seed=seed)
        sel = _assignment_from_embedding(U, cent, B, J)
        invs["envelope"] = np.argsort(sel, axis=1)           # (B, J)
        out["envelope"] = _emit(invs["envelope"])
    if band_align in ("init", "both", "all", "all+glue"):
        inv = np.zeros((B, J), np.int64)
        for b, s0 in enumerate(starts):
            oh = np.eye(J)[lab_b[pick[b]]]               # (Fb, N, J)
            wv = votes_init[s0:s0 + Fb] * pw[s0:s0 + Fb, :, None]
            T = np.einsum('fna,fnb->ab', oh, wv)[None]   # (1, J, J)
            # sel[j] = converged label assigned to init channel j;
            # invert so inv[converged label] = init channel
            inv[b] = np.argsort(_best_assignment(T)[0])
        invs["init"] = inv
        out["init"] = _emit(inv)
    if band_align in ("spatial", "all", "all+glue"):
        D = feat.shape[-1]
        nodes = np.zeros((B, J, D))
        npow_s = np.zeros((B, J))
        for b, s0 in enumerate(starts):
            sl = slice(s0, s0 + Fb)
            lab = lab_b[pick[b]]                           # (Fb, N)
            wts = np.asarray(pw[sl], np.float64)
            fb = np.asarray(feat[sl], np.float64)
            for k in range(J):
                m = (lab == k) * wts
                tot = float(m.sum())
                if tot > 0:
                    nodes[b, k] = np.einsum('fn,fnd->d', m, fb) / tot
                npow_s[b, k] = tot
        U = nodes.reshape(B * J, D)
        U = U / np.maximum(
            np.linalg.norm(U, axis=1, keepdims=True), 1e-12)
        cent = _spherical_kmeans(U, npow_s.reshape(-1), J, seed=seed)
        sel = _assignment_from_embedding(U, cent, B, J)
        invs["spatial"] = np.argsort(sel, axis=1)
        out["spatial"] = _emit(invs["spatial"])
    if band_align in ("glue", "all+glue"):
        perms, margins = glue_band_perms(
            X, J, probes, glue_iters=glue_iters, rank=rank,
            n_devices=n_devices, seed=seed, verbose=verbose, device=device)
        invs["glue"] = _chain_glue(perms, J)
        out["glue"] = _emit(invs["glue"])
    if not out:
        raise ValueError(f"band_align must be envelope|init|spatial|"
                         f"glue|both|all|all+glue, got {band_align!r}")
    multi = band_align in ("both", "all", "all+glue")
    res = out if multi else out[band_align]
    if return_detail:
        return res, {"probes": probes, "inv": invs}
    return res


def repair_votes(votes: np.ndarray, pw: np.ndarray,
                 corr_thr: float = 0.6, min_balance: float = 0.05,
                 max_hcorr: float = 0.9, verbose: bool = False
                 ) -> np.ndarray:
    """Fix the two systematic failure modes of blind spatial clustering.

    When sources share a mixing direction, the clustering (a) MERGES the
    same-direction pair into one cluster and (b) SPLITS some loud source
    across two clusters to fill the count. Detected and repaired from the
    votes alone:

    - split-source pair: two clusters whose temporal activity envelopes
      correlate above `corr_thr` -> merge them;
    - over-merged cluster: the remaining cluster whose masked power plane
      best factors into TWO spectro-temporally distinct components
      (rank-2 KL-NMF; score = activation decorrelation x power balance)
      -> split its votes by the per-bin component shares.

    Each pass performs one merge+split; passes repeat until no pair
    crosses `corr_thr` (at most J//2). If no candidate cluster splits
    acceptably, the merge is NOT performed -- repair never reduces the
    effective source count.
    """
    J = votes.shape[-1]
    votes = votes.copy()
    for _ in range(max(J // 2, 1)):
        wv = votes * pw[..., None]
        a = np.einsum('fnj->jn', wv)
        an = a - a.mean(-1, keepdims=True)
        an /= np.maximum(np.linalg.norm(an, axis=-1, keepdims=True), 1e-12)
        corr = an @ an.T
        np.fill_diagonal(corr, -2.0)
        i, k = np.unravel_index(np.argmax(corr), corr.shape)
        if corr[i, k] < corr_thr:
            break
        merged = votes[..., i] + votes[..., k]
        best = None
        for c in range(J):
            if c == k:
                continue
            Mc = (merged if c == i else votes[..., c]) * pw
            share, H = _nmf_split(Mc)
            # centered correlation of the two activations (see
            # _merge_split)
            h = H - H.mean(axis=1, keepdims=True)
            h /= np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-12)
            hcorr = abs(float((h[0] * h[1]).sum()))
            p0 = float((share * Mc).sum())
            p1 = float(((1.0 - share) * Mc).sum())
            bal = min(p0, p1) / max(p0 + p1, 1e-12)
            score = (1.0 - hcorr) * bal
            if best is None or score > best[0]:
                best = (score, c, share, hcorr, bal)
        score, c, share, hcorr, bal = best
        if bal < min_balance or hcorr > max_hcorr:
            break                        # no acceptable split: keep as-is
        if verbose:
            print(f"repair_votes: merge ({i},{k}) corr={corr[i, k]:.2f}; "
                  f"split {c} (hcorr={hcorr:.2f}, balance={bal:.2f})")
        votes[..., i] = merged
        src = merged if c == i else votes[..., c]
        votes[..., k] = src * (1.0 - share)
        votes[..., c] = src * share
    return votes


def activity_profiles(votes: np.ndarray, pw: np.ndarray,
                      floor: float = 0.3):
    """Per-source (time, band) energy profiles from the votes.

    Returns (tw_prof (J, N), fb_prof (J, F)), each normalized to peak 1
    and floored (floor + (1-floor) * profile): used to MODULATE the random
    TW/FB init, not replace it.
    """
    tw = np.einsum('fnj,fn->jn', votes, pw)
    tw /= np.maximum(tw.mean(-1, keepdims=True), 1e-20)
    tw = floor + (1.0 - floor) * tw / np.maximum(
        tw.max(-1, keepdims=True), 1e-20)
    fb = np.einsum('fnj,fn->jf', votes, pw)
    fb /= np.maximum(fb.mean(-1, keepdims=True), 1e-20)
    fb = floor + (1.0 - floor) * fb / np.maximum(
        fb.max(-1, keepdims=True), 1e-20)
    return tw, fb


def full_rank_init(X: np.ndarray, J: int, n_seeds: int = 8,
                   rank: int = 2, kiter: int = 30, backend: str = "device",
                   repair="select", probe_iters: int = 60,
                   verbose: bool = False, n_devices: int = 1,
                   device=DEFAULT_DEVICE
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot blind full-rank initialization.

    X (F, N, I) complex mixture STFT; returns (A_init (J, F, I, rank),
    tw_prof (J, N), fb_prof (J, F)). Feed A_init to
    `MultiChanNMFConv(spatial_rank=rank, init_mixing=A_init)` and the
    profiles to `apply_profiles`.

    repair -- how to resolve same-direction cluster merge/split failures:
      'select' (default): enumerate merge+split hypotheses
        (candidate_votes, and direction_split_candidates for J > 2) and
        pick by a `probe_iters`-iteration batched GEM probe
        (select_init_by_likelihood) on `device`;
      True: single-shot heuristic (repair_votes);
      False: no repair (sources known spatially distinct).
    """
    feat, w, pw, xx = tf_covariance_features(X)
    votes = consensus_votes(X, J, n_seeds=n_seeds, kiter=kiter,
                            backend=backend, device=device)
    if repair == "select":
        cands = candidate_votes(votes, pw)
        if J > 2:
            cands = cands + direction_split_candidates(
                X, J, pw, n_seeds=n_seeds, kiter=kiter, backend=backend,
                device=device)
        if len(cands) == 1:
            v = cands[0][1]
            A = mixing_from_votes(v, xx, pw, rank=rank)
            twp, fbp = activity_profiles(v, pw)
            return A, twp, fbp
        A, twp, fbp, name = select_init_by_likelihood(
            X, cands, xx, pw, rank=rank, probe_iters=probe_iters,
            verbose=verbose, n_devices=n_devices, device=device)
        if verbose:
            print(f"full_rank_init: selected {name} of {len(cands)}")
        return A, twp, fbp
    if repair:
        votes = repair_votes(votes, pw, verbose=verbose)
    A = mixing_from_votes(votes, xx, pw, rank=rank)
    tw_prof, fb_prof = activity_profiles(votes, pw)
    return A, tw_prof, fb_prof


def apply_profiles(params, tw_prof: Optional[np.ndarray] = None,
                   fb_prof: Optional[np.ndarray] = None):
    """Modulate each source's TW/FB init by its activity profiles.

    params: FasstParams (any clip count B) whose spec components map
    one-to-one to sources (spat_ind == source index). Returns the new
    FasstParams.
    """
    spec = []
    for comp in params.spec:
        j = comp.spat_ind
        kw = {}
        if tw_prof is not None:
            kw["TW"] = comp.TW * torch.as_tensor(
                tw_prof[j], dtype=comp.TW.dtype, device=comp.TW.device
            )[None, None, :]
        if fb_prof is not None:
            kw["FB"] = comp.FB * torch.as_tensor(
                fb_prof[j], dtype=comp.FB.dtype, device=comp.FB.device
            )[None, :, None]
        spec.append(comp.replace(**kw))
    return params.replace(spec=tuple(spec))
