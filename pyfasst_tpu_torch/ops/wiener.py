"""Multichannel Wiener separation.

Port of pyfasst_tpu/ops/wiener.py, with a leading clip axis B. I = 2 takes
the packed 2x2 forms below; any other channel count the general-I engine
(ops/engine_general.py). Posterior-mean source images:

    y^_j(f,n) = v_j(f,n) R_j(f) Sigma_x(f,n)^-1 x(f,n)

which sum to x as Sigma_b -> 0. The spatial-filter variant drops the PSD
weighting and uses only the spatial covariances.
"""
from __future__ import annotations

import torch

from pyfasst_tpu_torch.models.components import FasstParams
from pyfasst_tpu_torch.ops import herm
from pyfasst_tpu_torch.ops.engine_general import (
    separate_spatial_filter_general, separate_sources_general,
)
from pyfasst_tpu_torch.ops.estep import (
    cross_terms, mixture_cov, stable_mixture_det,
)
from pyfasst_tpu_torch.ops.gem import spatial_covs
from pyfasst_tpu_torch.ops.mstep import _as_conv_A
from pyfasst_tpu_torch.utils.precision import highest_precision

_I8 = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)  # packed general identity


def _herm_adj(P):
    """Packed adjugate of a packed Hermitian: [d, a, -b]."""
    return torch.stack([P[..., 1], P[..., 0], -P[..., 2], -P[..., 3]],
                       dim=-1)


@highest_precision
def separate_sources(params: FasstParams, X, sigma):
    """Wiener posterior-mean source images y^_j = v_j R_j Sigma_x^-1 x.

    X: (B, F, N, I) complex mixture STFT, sigma (B, F). Returns
    (B, J, F, N, I) complex. I != 2 takes the general-I engine
    (engine_general.separate_sources_general).

    Float32 numerics: computing R_j Sigma_x^-1 naively multiplies R_j by a
    noisy adjugate; near the annealed noise floor the (exactly zero for
    rank-1) product R_j adj(R_j) = det(R_j) I survives only as rounding
    noise amplified by 1/det. The 2x2 adjugate is LINEAR, so it is expanded
    analytically:

      R_j adj(Sigma_x) = sum_{k != j} v_k R_j adj(R_k)
                         + v_j det(R_j) I + sigma R_j,

    with det(R_j) = X_jj / 2 from the Lagrange cross terms and det(Sigma_x)
    from the nonnegative-monomial expansion.
    """
    if X.shape[-1] != 2:
        return separate_sources_general(params, X, sigma)
    F = X.shape[1]
    J = params.n_spat
    v = params.all_source_powers()                 # (B, J, F, N)
    Rj = spatial_covs(params, F)                   # (B, J, F, 4)
    A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
    trR, Xc = cross_terms(Rj, A_conv)
    det = stable_mixture_det(v, trR, Xc, sigma)    # (B, F, N)
    adjR = _herm_adj(Rj)
    Rj_gen = herm.herm_as_gen(Rj)                  # (B, J, F, 8)
    eye8 = torch.tensor(_I8, dtype=v.dtype, device=v.device)
    x0, x1 = X[..., 0], X[..., 1]
    outs = []
    for j in range(J):
        detR = 0.5 * Xc[:, j, j]                    # (B, F)
        num = sigma[:, :, None, None] * Rj_gen[:, j][:, :, None, :]
        num = num + (v[:, j] * detR[:, :, None])[..., None] * eye8
        for k in range(J):
            if k == j:
                continue
            Mjk = herm.mul(Rj[:, j], adjR[:, k])      # (B, F, 8)
            num = num + v[:, k][..., None] * Mjk[:, :, None, :]
        y0, y1 = herm.gen_apply(num, x0, x1)
        scale = v[:, j] / det
        outs.append(torch.stack([y0 * scale, y1 * scale], dim=-1))
    return torch.stack(outs, dim=1)                 # (B, J, F, N, 2)


@highest_precision
def separate_spatial_filter(params: FasstParams, X, sigma,
                            det_floor: float = 1e-30):
    """PSD-independent spatial filtering: G_j = R_j (sum_j' R_j' + sigma I)^-1.

    One filter per source per frequency. Returns (B, J, F, N, I) complex;
    I != 2 takes engine_general.separate_spatial_filter_general.
    """
    if X.shape[-1] != 2:
        return separate_spatial_filter_general(params, X, sigma)
    F = X.shape[1]
    Rj = spatial_covs(params, F)                   # (B, J, F, 4)
    Stot = herm.add_noise_diag(torch.sum(Rj, dim=1), sigma)
    Si = herm.inv(Stot, det_floor)                 # (B, F, 4)
    G = herm.mul(Rj, Si[:, None])                  # (B, J, F, 8)
    y0, y1 = herm.gen_apply(G[:, :, :, None, :], X[:, None, ..., 0],
                            X[:, None, ..., 1])
    return torch.stack([y0, y1], dim=-1)


def posterior_psd_masks(params: FasstParams, X, sigma):
    """Per-source Wiener PSD ratios v_j tr(R_j) / tr(Sigma_x), (B, J, F, N)."""
    F = X.shape[1]
    v = params.all_source_powers()
    Rj = spatial_covs(params, F)
    Sx = mixture_cov(v, Rj, sigma)
    return (v * herm.trace(Rj)[..., None]) / torch.clamp(
        herm.trace(Sx)[:, None], min=1e-30)


__all__ = ["separate_sources", "separate_spatial_filter",
           "posterior_psd_masks"]
