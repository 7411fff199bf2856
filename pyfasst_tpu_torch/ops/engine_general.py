"""General-I (I != 2 channels) GEM E-step and Wiener separation.

Port of pyfasst_tpu/ops/engine_general.py, with a leading clip axis B:
planes are (B, F, N), sigma is (B, F), A_conv[j] is complex (B, F, I, R_j).
gem_step (ops/gem.py) and ops/wiener.py dispatch here on X.shape[-1] != 2,
on either device. This engine has no hand kernel: the JAX package's is
plain XLA with no Pallas kernel, so on the CPU and on CUDA alike it is
plain PyTorch, every I x I operation unrolled over nested lists of planes
(static I and ranks; each step elementwise over the (f, n) plane).

Float32 numerics: the square-root (QR row-update) form. A plain Cholesky
of Sigma_x = sigma I + sum_j v_j A_j A_j^H collapses in float32: late in
annealing cond(Sigma_x) ~ v_max/sigma exceeds 1e8, the pivot subtraction
d_i = M_ii - sum |L_im|^2 cancels (computed pivots go negative while the
true pivots are >= sigma), and the statistics and Wiener masks blow up by
orders of magnitude. Instead the upper-triangular factor R with
R^H R = Sigma_x is kept directly, starting from the exact factor
sqrt(sigma) I and absorbing each scaled mixing row sqrt(v_j) a_jr^H with a
Givens rotation. Every pivot update is h = sqrt(a^2 + |b|^2), with no
subtraction, so R_ii >= sqrt(sigma), log det Sigma_x = 2 sum_i log R_ii
is exact to rounding, and every solve is triangular with
cond(R) = sqrt(cond(Sigma_x)). The posterior-variance statistics keep the
subtract-free leave-one-out Woodbury form of the 2x2 path, with
G_j = I_R + v_j A_j^H S_j^-1 A_j accumulated in square-root form too
(pivots >= 1) and tr(G^-1) = ||R_G^-1||_F^2, a sum of squares.

The order of every sum is the JAX package's (Python ``sum`` over the same
generators), so float64 runs agree with it to rounding.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from pyfasst_tpu_torch.models.components import complex_dtype
from pyfasst_tpu_torch.ops.estep import SuffStats


# -- unrolled square-root accumulation ----------------------------------------
# Upper-triangular factors are nested lists R[i][k] (k >= i) of
# broadcast-compatible (B, F, N) planes with real diagonals.

def _abs2(z):
    """|z|^2 as re^2 + im^2 (abs() would round through hypot); z^2 for a
    real plane."""
    if not z.is_complex():
        return z ** 2
    return z.real ** 2 + z.imag ** 2


def _sqrt_identity(diag, I: int) -> List[List[torch.Tensor]]:
    """R = diag * I (the exact factor of diag^2 * I); diag a real plane."""
    return [[diag if i == k else None for k in range(I)] for i in range(I)]


def _absorb_row(R: List[List[torch.Tensor]], u: Sequence[torch.Tensor],
                I: int) -> None:
    """Rank-1 QR row-update: R^H R += u u^H, in place.

    The appended row is w = conj(u); each Givens step zeroes w[i] against
    the real pivot R[i][i] via h = sqrt(a^2 + |w_i|^2): no subtraction ever
    reaches a pivot, so R[i][i] >= its initial value throughout.
    """
    w = [u[k].conj() for k in range(I)]
    for i in range(I):
        a = R[i][i]
        wi = w[i]
        h = torch.sqrt(a * a + _abs2(wi))
        c = a / h
        s = wi.conj() / h
        g = wi / h
        for k in range(i + 1, I):
            Rik, wk = R[i][k], w[k]
            if Rik is None:                      # still the identity pattern
                R[i][k] = s * wk
                w[k] = c * wk
            else:
                R[i][k] = c * Rik + s * wk
                w[k] = c * wk - g * Rik
        R[i][i] = h


def _complex_zeros(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like, dtype=complex_dtype(like.dtype))


def _sqrt_factor(diag, scaled_rows, I: int) -> List[List[torch.Tensor]]:
    """Factor of diag^2 I + sum_r u_r u_r^H (diag real, u_r complex I-vecs)."""
    R = _sqrt_identity(diag, I)
    for u in scaled_rows:
        _absorb_row(R, u, I)
    for i in range(I):                            # fill untouched zeros
        for k in range(i + 1, I):
            if R[i][k] is None:
                R[i][k] = _complex_zeros(R[i][i])
    return R


def _logdet(R: List[List[torch.Tensor]]) -> torch.Tensor:
    out = None
    for i in range(len(R)):
        t = torch.log(R[i][i])
        out = t if out is None else out + t
    return 2.0 * out


def _solve(R: List[List[torch.Tensor]], b: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """Solve (R^H R) y = b: forward substitution on R^H, back on R."""
    n = len(R)
    z = []
    for i in range(n):
        s = b[i]
        for m in range(i):
            s = s - R[m][i].conj() * z[m]
        z.append(s / R[i][i])
    y: List[torch.Tensor] = [None] * n
    for i in reversed(range(n)):
        s = z[i]
        for k in range(i + 1, n):
            s = s - R[i][k] * y[k]
        y[i] = s / R[i][i]
    return y


def _columns(A: torch.Tensor, r: int, N: int) -> List[torch.Tensor]:
    """Column r of A (B, F, I, Rk) as I planes broadcast to (B, F, N)."""
    B, F, I, _ = A.shape
    return [A[:, :, i, r][:, :, None].expand(B, F, N) for i in range(I)]


def _forward_cols(R, A: torch.Tensor, N: int) -> List[List[torch.Tensor]]:
    """W = R^-H A for A (B, F, I, Rk): W[r][i] planes, so that
    A^H (R^H R)^-1 A = W^H W."""
    I, Rk = A.shape[2], A.shape[3]
    out = []
    for r in range(Rk):
        b = _columns(A, r, N)
        z = []
        for i in range(I):
            s = b[i]
            for m in range(i):
                s = s - R[m][i].conj() * z[m]
            z.append(s / R[i][i])
        out.append(z)
    return out


def _solve_cols(R, A: torch.Tensor, N: int) -> List[List[torch.Tensor]]:
    """U = (R^H R)^-1 A for A (B, F, I, Rk): U[r][i] is a (B, F, N) plane."""
    return [_solve(R, _columns(A, r, N)) for r in range(A.shape[3])]


def _tri_inv(R: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
    """B = R^-1 (upper triangular) by back substitution on columns."""
    n = len(R)
    B: List[List[torch.Tensor]] = [[None] * n for _ in range(n)]
    for k in range(n):
        for i in range(k, -1, -1):
            if i == k:
                B[i][k] = 1.0 / R[i][i]
            else:
                s = None
                for m in range(i + 1, k + 1):
                    t = R[i][m] * B[m][k]
                    s = t if s is None else s + t
                B[i][k] = -s / R[i][i]
    return B


def _mixture_rows(v, A_conv, ranks, J):
    """Scaled mixing rows sqrt(v_j) a_jr as (source, rank)-tagged I-vectors."""
    rows = []
    for j in range(J):
        sv = torch.sqrt(v[:, j])                  # (B, F, N) real
        for r in range(ranks[j]):
            rows.append((j, [sv * A_conv[j][:, :, i, r][:, :, None]
                             for i in range(A_conv[j].shape[2])]))
    return rows


def _frame_sum(t):
    return torch.sum(t, dim=-1)


def suff_stats_general(
    X: torch.Tensor,           # (B, F, N, I) complex mixture transform
    v: torch.Tensor,           # (B, J, F, N) source PSDs
    A_conv: Tuple,             # per j: complex (B, F, I, R_j) mixing
    sigma: torch.Tensor,       # (B, F) annealed noise PSD
    ranks: Tuple[int, ...],
    eps: float = 1e-30,
    noise_inject: bool = False,
) -> SuffStats:
    """One E-step over the (f, n) plane for any channel count I.

    The sufficient statistics of ops/estep.compute_suff_stats, with T4_j
    complex (B, F, R, R) for R >= 2 (the packed-Hermitian T4 encoding is
    2x2-only) and (B, F) for rank 1. eps is unused: the pivots are bounded
    below by sqrt(sigma) by construction.
    """
    del eps
    B, F, N, I = X.shape
    J = v.shape[1]
    sq_sigma = torch.sqrt(sigma)[:, :, None]      # (B, F, 1) real
    sig = sigma[:, :, None]
    rows = _mixture_rows(v, A_conv, ranks, J)

    Rm = _sqrt_factor(sq_sigma, [u for _, u in rows], I)
    logdet = _logdet(Rm)

    xs = [X[..., i] for i in range(I)]
    y = _solve(Rm, xs)                            # Sigma_x^-1 x
    trSxiRxx = torch.clamp(
        sum((xs[i].conj() * y[i]).real for i in range(I)), min=0.0)

    # U[k][r][i] = (Sigma_x^-1 A_k)[i, r]: needed for T7 (J >= 2) and for
    # every noise-injection correction.
    need_U = noise_inject or J >= 2
    U = [_solve_cols(Rm, A_conv[k], N) for k in range(J)] if need_U else None
    if noise_inject:
        # tr(Sigma_x^-1) = ||Rm^-1||_F^2: a sum of squares
        Bi = _tri_inv(Rm)
        tr_inv = sum(_abs2(Bi[i][k]) for i in range(I) for k in range(i, I))
        trSxiRxx = trSxiRxx + sig * tr_inv

    def AH_dot(A, yv):
        Ic, Rk = A.shape[2], A.shape[3]
        return [sum(A[:, :, i, r].conj()[:, :, None] * yv[i]
                    for i in range(Ic)) for r in range(Rk)]

    w = [AH_dot(A_conv[j], y) for j in range(J)]  # w_j = A_j^H y

    xi_list, T4_list, Txs_list = [], [], []
    for j in range(J):
        R = ranks[j]
        Aj = A_conv[j]
        vj = v[:, j]
        trCR = sum(_abs2(w[j][r]) for r in range(R))
        if noise_inject:
            trCR = trCR + sig * sum(
                _abs2(U[j][r][i]) for r in range(R) for i in range(I))

        # leave-one-out Woodbury posterior G = I_R + v_j A_j^H S_j^-1 A_j,
        # itself in square-root form: W = R_loo^-H A_j, then absorb the
        # rows sqrt(v_j) conj(W_i) into R_G starting from the exact I_R.
        Rloo = _sqrt_factor(sq_sigma,
                            [u for (k, u) in rows if k != j], I)
        W = _forward_cols(Rloo, Aj, N)            # W[r][i]
        svj = torch.sqrt(vj)
        ones = torch.ones((B, F, N), dtype=X.real.dtype, device=X.device)
        RG = _sqrt_identity(ones, R)
        for i in range(I):
            _absorb_row(RG, [svj * W[r][i].conj() for r in range(R)], R)
        for p in range(R):
            for q in range(p + 1, R):
                if RG[p][q] is None:
                    RG[p][q] = _complex_zeros(ones)
        BG = _tri_inv(RG)                         # R_G^-1
        trGinv = sum(_abs2(BG[p][k]) for p in range(R)
                     for k in range(p, R))        # ||R_G^-1||_F^2 >= 0
        if R == 1:
            T4_list.append(_frame_sum(vj * trGinv))              # (B, F)
        else:
            # G^-1 = B B^H
            def ginv(p, q):
                lo = max(p, q)
                return sum(BG[p][k] * BG[q][k].conj()
                           for k in range(lo, R))
            T4 = torch.stack(
                [torch.stack([_frame_sum(vj * ginv(p, q))
                              for q in range(R)], dim=-1)
                 for p in range(R)], dim=-2)                     # (B, F, R, R)
            T4_list.append(T4)
        xi_list.append((vj * vj * trCR + vj * trGinv) / R)

        # Txs_j(f) = sum_n v_j x w_j^H, (B, F, I, R)
        Txs = torch.stack(
            [torch.stack([_frame_sum(vj * xs[i] * w[j][r].conj())
                          for r in range(R)], dim=-1)
             for i in range(I)], dim=-2)
        if noise_inject:
            Txs = Txs + sigma[:, :, None, None] * torch.stack(
                [torch.stack([_frame_sum(vj * U[j][r][i])
                              for r in range(R)], dim=-1)
                 for i in range(I)], dim=-2)
        Txs_list.append(Txs)
    xi = torch.clamp(torch.stack(xi_list, dim=1), min=1e-30)

    Tss, T7 = [], []
    for j in range(J):
        row_ss, row_7 = [], []
        for k in range(J):
            vv = v[:, j] * v[:, k]
            ss = torch.stack(
                [torch.stack([_frame_sum(vv * w[j][p] * w[k][q].conj())
                              for q in range(ranks[k])], dim=-1)
                 for p in range(ranks[j])], dim=-2)          # (B, F, Rj, Rk)
            if noise_inject:
                ss = ss + torch.stack(
                    [torch.stack([_frame_sum(
                        sig * vv * sum(
                            U[j][p][i].conj() * U[k][q][i]
                            for i in range(I)))
                        for q in range(ranks[k])], dim=-1)
                     for p in range(ranks[j])], dim=-2)
            row_ss.append(ss)
            if k == j:
                row_7.append(None)
            else:
                # T7_jk = sum_n v_j v_k A_j^H Sigma_x^-1 A_k
                row_7.append(torch.stack(
                    [torch.stack([_frame_sum(vv * sum(
                        A_conv[j][:, :, i, p].conj()[:, :, None] * U[k][q][i]
                        for i in range(I)))
                        for q in range(ranks[k])], dim=-1)
                     for p in range(ranks[j])], dim=-2))
        Tss.append(tuple(row_ss))
        T7.append(tuple(row_7))

    loglik = -torch.sum(logdet + trSxiRxx, dim=(1, 2))
    return SuffStats(xi=xi, Txs=tuple(Txs_list), Tss=tuple(Tss),
                     T4=tuple(T4_list), T7=tuple(T7), loglik=loglik)


# -- separation ---------------------------------------------------------------

def _images(A_conv, ranks, y, scale, I):
    """Per source j: scale_j * A_j A_j^H y as (B, F, N, I)."""
    outs = []
    for j, Aj in enumerate(A_conv):
        wj = [sum(Aj[:, :, i, r].conj()[:, :, None] * y[i]
                  for i in range(I)) for r in range(ranks[j])]
        img = [sum(Aj[:, :, i, r][:, :, None] * wj[r]
                   for r in range(ranks[j])) for i in range(I)]
        if scale is not None:
            img = [scale[:, j] * t for t in img]
        outs.append(torch.stack(img, dim=-1))
    return torch.stack(outs, dim=1)


def separate_sources_general(params, X: torch.Tensor, sigma: torch.Tensor,
                             eps: float = 1e-30) -> torch.Tensor:
    """Wiener posterior means y^_j = v_j A_j A_j^H Sigma_x^-1 x for any I.

    X: (B, F, N, I) complex, sigma (B, F). Returns (B, J, F, N, I) complex.
    The square-root solve replaces the 2x2 path's adjugate expansion: the
    triangular factor carries cond(R) = sqrt(cond(Sigma_x)), so the masks
    stay accurate at the annealed noise floor.
    """
    from pyfasst_tpu_torch.ops.mstep import _as_conv_A

    del eps
    F, I = X.shape[1], X.shape[3]
    J = params.n_spat
    v = params.all_source_powers()
    A_conv = [_as_conv_A(c, F) for c in params.spat]
    ranks = tuple(c.rank for c in params.spat)
    rows = _mixture_rows(v, A_conv, ranks, J)
    Rm = _sqrt_factor(torch.sqrt(sigma)[:, :, None], [u for _, u in rows], I)
    y = _solve(Rm, [X[..., i] for i in range(I)])
    return _images(A_conv, ranks, y, v, I)


def separate_spatial_filter_general(params, X: torch.Tensor,
                                    sigma: torch.Tensor,
                                    eps: float = 1e-30) -> torch.Tensor:
    """PSD-independent spatial filter G_j = R_j (sum_k R_k + sigma I)^-1
    applied per frequency, any I. Returns (B, J, F, N, I)."""
    from pyfasst_tpu_torch.ops.mstep import _as_conv_A

    del eps
    F, I = X.shape[1], X.shape[3]
    A_conv = [_as_conv_A(c, F) for c in params.spat]
    ranks = tuple(c.rank for c in params.spat)
    # per-frequency factor: planes are (B, F, 1) so they broadcast over frames
    rows = [[A[:, :, i, r][:, :, None] for i in range(I)]
            for A, R in zip(A_conv, ranks) for r in range(R)]
    Rt = _sqrt_factor(torch.sqrt(sigma)[:, :, None], rows, I)
    y = _solve(Rt, [X[..., i] for i in range(I)])
    return _images(A_conv, ranks, y, None, I)
