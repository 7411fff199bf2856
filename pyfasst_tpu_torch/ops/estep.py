"""GEM E-step: exact Gaussian sufficient statistics (plain PyTorch).

Port of pyfasst_tpu/ops/estep.py, with a leading clip axis B. This is the
CPU path of gem_step; on CUDA the E-step runs in the hand-written kernel
(ops/cuda_estep.py). Every statistic is accumulated in a cancellation-free
form. With

    y(f,n)   = Sigma_x^-1 x            (2-vector)
    w_j(f,n) = A_j^H y                 (R_j-vector; the unit-PSD Wiener image
                                        of source j's sub-sources: s^_j = v_j w_j)

the sufficient statistics are outer products (errors enter squared):

    xi_j     = [v^2 ||w_j||^2 + v tr_R((I + v A^H S_j^-1 A)^-1)] / R_j
    Txs_j(f) = sum_n v_j x w_j^H                      -> R^_xs,j
    Tss_jk(f)= sum_n v_j v_k w_j w_k^H                -> Wiener part of R^_ss
    T4_j(f)  = sum_n v_j (I + v_j A_j^H S_j^-1 A_j)^-1   (diag posterior cov,
               Woodbury through the leave-one-out
               S_j = sum_{k != j} v_k R_k + sigma I -- subtract-free)
    T7_jk(f) = sum_n v_j v_k A_j^H Sigma_x^-1 A_k    (cross posterior cov,
               j != k)

so the M-step blocks are  R^_ss[j,j] = Tss_jj + T4_j  and
R^_ss[j,k] = Tss_jk - T7_jk, with no congruences of summed statistics.
det(Sigma_x) comes from the nonnegative-monomial expansion below.

Shapes: X (B, F, N, 2) complex, v (B, J, F, N), Rj (B, J, F, 4) packed,
sigma (B, F), A_conv[j] complex (B, F, 2, R_j).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pyfasst_tpu_torch.ops import herm


@dataclasses.dataclass
class SuffStats:
    """Per-source reduced statistics of one E-step (see module docstring).

    Txs: tuple over j of complex (B, F, 2, R_j).
    Tss: nested tuple (j, k) of complex (B, F, R_j, R_k).
    T4:  tuple over j: (B, F) for rank-1, packed Hermitian (B, F, 4) for
         rank-2.
    T7:  nested tuple (j, k), complex (B, F, R_j, R_k); None on the diagonal.
    """

    xi: torch.Tensor      # (B, J, F, N) posterior sub-source PSDs
    Txs: tuple
    Tss: tuple
    T4: tuple
    T7: tuple
    loglik: torch.Tensor  # (B,): sum_{f,n} -(logdet Sigma_x + x^H Sigma_x^-1 x)


def mixture_cov(v, Rj, sigma):
    """Packed Sigma_x(f,n) = sum_j v_j(f,n) R_j(f) + sigma(f) I, (B, F, N, 4)."""
    Sx = torch.einsum("bjfn,bjfk->bfnk", v, Rj)
    return herm.add_noise_diag(Sx, sigma[:, :, None])


def cross_terms(Rj, A_conv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frequency spatial invariants for the cancellation-free determinant.

    Returns trR (B, J, F) and X (B, J, J, F) with
        X[j, k] = tr(R_j) tr(R_k) - tr(R_j R_k)
    computed WITHOUT the subtraction, via Lagrange's identity over the
    mixing columns:
        X[j, k] = sum_{r, s} |A_j[0, r] A_k[1, s] - A_j[1, r] A_k[0, s]|^2,
    which also covers the diagonal (X[j, j] = 2 det R_j, exactly 0 for
    rank-1). The subtracted form cancels catastrophically in float32 when
    two sources' directions are near-parallel.
    """
    trR = herm.trace(Rj)                                  # (B, J, F)
    J = Rj.shape[1]
    rows = []
    for j in range(J):
        a = A_conv[j]                                     # (B, F, 2, Rj)
        row = []
        for k in range(J):
            b = A_conv[k]                                 # (B, F, 2, Rk)
            c = (a[:, :, 0, :, None] * b[:, :, 1, None, :]
                 - a[:, :, 1, :, None] * b[:, :, 0, None, :])
            row.append(torch.sum(c.real ** 2 + c.imag ** 2, dim=(2, 3)))
        rows.append(torch.stack(row, dim=1))
    return trR, torch.stack(rows, dim=1)                  # (B, J, J, F)


def stable_mixture_det(v, trR, X, sigma):
    """det Sigma_x(f,n) as a sum of NONNEGATIVE monomials:

        det = sigma^2 + sigma sum_j v_j tr(R_j) + 1/2 sum_{j,k} v_j v_k X_jk.

    The naive a*d - |b|^2 carries float32 cancellation noise ~eps * v^2 that
    swamps the true det once one source dominates a bin. Every term here is
    >= 0, so the result is exact to f32 rounding and needs no floors.
    """
    s = sigma[:, :, None]
    lin = torch.einsum("bjfn,bjf->bfn", v, trR)
    quad = 0.5 * torch.einsum("bjfn,bkfn,bjkf->bfn", v, v, X)
    return s * s + s * lin + quad


def stable_inv(S, det):
    """Packed inverse from adjugate entries and an externally computed det."""
    r = 1.0 / det
    return torch.stack([S[..., 1] * r, S[..., 0] * r,
                        -S[..., 2] * r, -S[..., 3] * r], dim=-1)


def _apply_AH(A, y0, y1):
    """w = A^H y for A (B, F, 2, R) complex, y (B, F, N) -> (B, F, N, R)."""
    return (A[:, :, None, 0, :].conj() * y0[..., None]
            + A[:, :, None, 1, :].conj() * y1[..., None])


def _sum_frames(t):
    """Sum over the frame axis (axis 2 of a (B, F, N, ...) tensor)."""
    return torch.sum(t, dim=2)


def compute_suff_stats(X, v, Rj, sigma, ranks: Tuple[int, ...],
                       eps: float = 1e-30, noise_inject: bool = False,
                       A_conv: Tuple = ()) -> SuffStats:
    """One E-step over the full (f, n) plane of every clip.

    Float32 safety rules (each found by bisecting a collapsing run against
    the float64 oracle):
      - dets via nonnegative monomials (stable_mixture_det / cross_terms);
      - statistics as outer products of x, y, w (never congruences of sums);
      - posterior variances via leave-one-out Woodbury (never rank - v*tr).
    """
    trR, Xc = cross_terms(Rj, A_conv)
    Sx = mixture_cov(v, Rj, sigma)                      # (B, F, N, 4)
    detSx = stable_mixture_det(v, trR, Xc, sigma)       # (B, F, N) > 0
    Sxi = stable_inv(Sx, detSx)
    sig = sigma[:, :, None]                             # (B, F, 1)

    x0, x1 = X[..., 0], X[..., 1]
    y0, y1 = herm.herm_apply(Sxi, x0, x1)                # y = Sigma_x^-1 x
    trSxiRxx = torch.clamp(
        (x0.conj() * y0 + x1.conj() * y1).real, min=0.0)

    J = v.shape[1]
    w = [_apply_AH(A_conv[j], y0, y1) for j in range(J)]  # (B, F, N, Rj)
    if noise_inject:
        # 'ann_ns_inj': observed covariance becomes x x^H + sigma I; the
        # additive corrections flow through z_j = Sigma_x^-1 A_j,
        # (2, B, F, N, R).
        z = []
        for j in range(J):
            cols = []
            for r in range(ranks[j]):
                u0, u1 = herm.herm_apply(Sxi, A_conv[j][:, :, None, 0, r],
                                         A_conv[j][:, :, None, 1, r])
                cols.append(torch.stack([u0, u1], dim=0))
            z.append(torch.stack(cols, dim=-1))
        trSxiRxx = trSxiRxx + sig * herm.trace(Sxi)

    xi_list, T4_list, Txs_list = [], [], []
    for j in range(J):
        vj = v[:, j]                                      # (B, F, N)
        wj = w[j]
        trCR_j = torch.sum(wj.real ** 2 + wj.imag ** 2, dim=-1)
        if noise_inject:
            trCR_j = trCR_j + sig * torch.sum(z[j].abs() ** 2, dim=(0, -1))
        if J == 1:
            Sj = torch.zeros_like(Sx)
        else:
            Sj = sum(v[:, k][..., None] * Rj[:, k][:, :, None, :]
                     for k in range(J) if k != j)
        Sj = herm.add_noise_diag(Sj, sig)                # (B, F, N, 4)
        vmask = v.clone()
        vmask[:, j] = 0.0                                 # leave-one-out det
        Sji = stable_inv(Sj, stable_mixture_det(vmask, trR, Xc, sigma))
        t = herm.trace_prod(Sji, Rj[:, j][:, :, None, :])  # (B, F, N) >= 0
        vt = vj * t
        if ranks[j] >= 2:
            # full-rank: G = I_2 + v A^H S^-1 A is Hermitian PD with
            # det >= 1 -- its inverse needs no loading and no subtraction.
            M = herm.sandwich22(A_conv[j][:, :, None], Sji)
            G = herm.add_noise_diag(vj[..., None] * M, 1.0)
            dG = torch.clamp(herm.det(G), min=1.0)
            Ginv = torch.stack([G[..., 1], G[..., 0], -G[..., 2],
                                -G[..., 3]], dim=-1) / dG[..., None]
            T4_list.append(_sum_frames(vj[..., None] * Ginv))
            coef = torch.clamp((2.0 + vt) / dG, min=0.0)
        else:
            den = 1.0 + vt
            coef = torch.clamp((2.0 + vt) / den - 1.0, min=0.0)
            T4_list.append(torch.sum(vj / den, dim=-1))  # (B, F)
        xi_list.append((vj * vj * trCR_j + vj * coef) / ranks[j])

        # R^_xs statistic: sum_n v_j x w_j^H  (B, F, 2, Rj)
        cw = wj.conj()
        Txs = torch.stack([_sum_frames(vj[..., None] * (x0[..., None] * cw)),
                           _sum_frames(vj[..., None] * (x1[..., None] * cw))],
                          dim=2)
        if noise_inject:
            zs = torch.sum(vj[None, ..., None] * z[j], dim=3)   # (2,B,F,R)
            Txs = Txs + sigma[:, :, None, None] * zs.permute(1, 2, 0, 3)
        Txs_list.append(Txs)
    xi = torch.clamp(torch.stack(xi_list, dim=1), min=eps)

    # Cross statistics: Tss_jk = sum_n v_j v_k w_j w_k^H and the cross
    # posterior covariance T7_jk = sum_n v_j v_k A_j^H Sigma_x^-1 A_k.
    Tss, T7 = [], []
    for j in range(J):
        row_ss, row_7 = [], []
        for k in range(J):
            vv = (v[:, j] * v[:, k])[..., None, None]
            row_ss.append(_sum_frames(
                vv * (w[j][..., :, None] * w[k].conj()[..., None, :])))
            if k == j:
                row_7.append(None)
            else:
                cols = []
                for r in range(ranks[k]):
                    u0, u1 = herm.herm_apply(Sxi, A_conv[k][:, :, None, 0, r],
                                             A_conv[k][:, :, None, 1, r])
                    cols.append(_apply_AH(A_conv[j], u0, u1))
                Mjk = torch.stack(cols, dim=-1)       # (B, F, N, Rj, Rk)
                row_7.append(_sum_frames(vv * Mjk))
        Tss.append(row_ss)
        T7.append(tuple(row_7))
    if noise_inject:
        for j in range(J):
            for k in range(J):
                vvs = v[:, j] * v[:, k] * sig
                corr = torch.sum(vvs[None, ..., None, None]
                                 * (z[j].conj()[..., :, None]
                                    * z[k][..., None, :]), dim=(0, 3))
                Tss[j][k] = Tss[j][k] + corr
    Tss = tuple(tuple(r) for r in Tss)

    loglik = -torch.sum(torch.log(detSx) + trSxiRxx, dim=(1, 2))
    return SuffStats(xi=xi, Txs=tuple(Txs_list), Tss=Tss,
                     T4=tuple(T4_list), T7=tuple(T7), loglik=loglik)
