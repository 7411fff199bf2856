"""Packed 2x2 Hermitian algebra.

Port of pyfasst_tpu/ops/herm.py. The whole algebra works on a packed real
layout, so the (f, n)-plane work is elementwise math with no per-bin
matrix products:

  - Hermitian H = [[a, b], [conj(b), d]] is packed as (..., 4) real:
        H[..., 0]=a, H[..., 1]=d, H[..., 2]=Re b, H[..., 3]=Im b.
  - A general complex 2x2 M is packed as (..., 8) real:
        [Re m00, Im m00, Re m01, Im m01, Re m10, Im m10, Re m11, Im m11].

Identities used throughout the GEM engine:
    inv(H)        = [[d, -b], [-conj(b), a]] / (a*d - |b|^2)
    tr(P @ Q)     = pa*qa + pd*qd + 2*(pbr*qbr + pbi*qbi)        (real)
    congruence    = Ai @ R @ Ai  for Hermitian Ai, R (Hermitian result)
All functions broadcast over leading axes (the clip axis B included).
"""
from __future__ import annotations

import torch


def _re(x: torch.Tensor) -> torch.Tensor:
    return x.real if x.is_complex() else x


def _im(x: torch.Tensor) -> torch.Tensor:
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _cplx(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re, im)


# -- pack / unpack ------------------------------------------------------------

def pack_herm(a, d, b_complex):
    """Pack real diagonals and the complex upper off-diagonal."""
    return torch.stack([a, d, _re(b_complex), _im(b_complex)], dim=-1)


def herm_from_complex(H):
    """(..., 2, 2) complex Hermitian -> (..., 4) packed real."""
    return torch.stack([_re(H[..., 0, 0]), _re(H[..., 1, 1]),
                        _re(H[..., 0, 1]), _im(H[..., 0, 1])], dim=-1)


def herm_to_complex(P):
    """(..., 4) packed -> (..., 2, 2) complex Hermitian."""
    zero = torch.zeros_like(P[..., 0])
    a = _cplx(P[..., 0], zero)
    d = _cplx(P[..., 1], zero)
    b = _cplx(P[..., 2], P[..., 3])
    row0 = torch.stack([a, b], dim=-1)
    row1 = torch.stack([b.conj(), d], dim=-1)
    return torch.stack([row0, row1], dim=-2).resolve_conj()


def herm_from_outer(x0, x1):
    """Packed x @ x^H for x = (x0, x1) complex: the empirical covariance."""
    a = _re(x0) ** 2 + _im(x0) ** 2
    d = _re(x1) ** 2 + _im(x1) ** 2
    b = x0 * x1.conj()
    return pack_herm(a, d, b)


# -- core ops (all real arithmetic; broadcast over leading axes) --------------

def det(P):
    """Real determinant a*d - |b|^2 of a packed Hermitian.

    Cancels in float32 when cond(P) is large: the GEM engine never uses it
    on the mixture covariance (see estep.stable_mixture_det)."""
    return P[..., 0] * P[..., 1] - (P[..., 2] ** 2 + P[..., 3] ** 2)


def load_diag(P, rel: float = 1e-6):
    """P + tau*I with tau = rel * trace(P): diagonal loading.

    Inverting the loaded matrix is always consistent (it is the exact
    inverse of a nearby PSD matrix), unlike clamping the determinant.
    """
    tau = rel * (P[..., 0] + P[..., 1])
    zeros = torch.zeros_like(tau)
    return P + torch.stack([tau, tau, zeros, zeros], dim=-1)


def inv(P, det_floor: float = 1e-30, rel: float = 1e-6):
    """Closed-form inverse of a packed Hermitian PD 2x2, diagonally loaded.

    rel bounds cond of the loaded matrix at ~1/rel (float32-resolvable).
    """
    L = load_diag(P, rel)
    dt = torch.clamp(det(L), min=det_floor)
    r = 1.0 / dt
    return torch.stack([L[..., 1] * r, L[..., 0] * r,
                        -L[..., 2] * r, -L[..., 3] * r], dim=-1)


def trace(P):
    return P[..., 0] + P[..., 1]


def trace_prod(P, Q):
    """tr(P @ Q) for packed Hermitians (real)."""
    return (P[..., 0] * Q[..., 0] + P[..., 1] * Q[..., 1]
            + 2.0 * (P[..., 2] * Q[..., 2] + P[..., 3] * Q[..., 3]))


def congruence(Ai, R):
    """Packed Ai @ R @ Ai for Hermitian Ai, R (result Hermitian).

    With Ai = [[p, q], [q*, s]] (p, s real) and R = [[u, v], [v*, w]]:
        S00 = p^2 u + 2 p Re(q v*) + |q|^2 w
        S11 = |q|^2 u + 2 s Re(q v*) + s^2 w
        S01 = p u q + s w q + p s v + q^2 v*
    """
    p, s = Ai[..., 0], Ai[..., 1]
    qr, qi = Ai[..., 2], Ai[..., 3]
    u, w = R[..., 0], R[..., 1]
    vr, vi = R[..., 2], R[..., 3]
    q2 = qr * qr + qi * qi
    dotqv = qr * vr + qi * vi             # Re(q v*)
    s00 = p * p * u + 2.0 * p * dotqv + q2 * w
    s11 = q2 * u + 2.0 * s * dotqv + s * s * w
    q2r, q2i = qr * qr - qi * qi, 2.0 * qr * qi
    q2v_r = q2r * vr + q2i * vi
    q2v_i = q2i * vr - q2r * vi
    s01r = p * u * qr + s * w * qr + p * s * vr + q2v_r
    s01i = p * u * qi + s * w * qi + p * s * vi + q2v_i
    return torch.stack([s00, s11, s01r, s01i], dim=-1)


def mul(P, Q):
    """General product of two packed Hermitians -> packed general (..., 8).

    With P = [[a, b], [b*, d]], Q = [[u, v], [v*, w]]:
        M00 = a u + b v*,  M01 = a v + b w,
        M10 = b* u + d v*, M11 = b* v + d w.
    """
    a, d = P[..., 0], P[..., 1]
    br, bi = P[..., 2], P[..., 3]
    u, w = Q[..., 0], Q[..., 1]
    vr, vi = Q[..., 2], Q[..., 3]
    m00r = a * u + br * vr + bi * vi
    m00i = bi * vr - br * vi
    m01r = a * vr + br * w
    m01i = a * vi + bi * w
    m10r = br * u + d * vr
    m10i = -bi * u - d * vi
    m11r = br * vr + bi * vi + d * w
    m11i = br * vi - bi * vr
    return torch.stack([m00r, m00i, m01r, m01i, m10r, m10i, m11r, m11i],
                       dim=-1)


def gen_to_complex(M):
    """(..., 8) packed general -> (..., 2, 2) complex."""
    c = _cplx(M[..., 0::2], M[..., 1::2])   # (..., 4): m00, m01, m10, m11
    return c.reshape(c.shape[:-1] + (2, 2))


def gen_apply(M, x0, x1):
    """y = M @ x for packed general M (..., 8) and complex x components."""
    m00 = _cplx(M[..., 0], M[..., 1])
    m01 = _cplx(M[..., 2], M[..., 3])
    m10 = _cplx(M[..., 4], M[..., 5])
    m11 = _cplx(M[..., 6], M[..., 7])
    return m00 * x0 + m01 * x1, m10 * x0 + m11 * x1


def add_noise_diag(P, sigma):
    """P + sigma * I for packed Hermitian, sigma real broadcastable."""
    zeros = torch.zeros_like(P[..., 2])
    s = torch.as_tensor(sigma, dtype=P.dtype, device=P.device)
    s = torch.broadcast_to(s, P[..., 0].shape)
    return P + torch.stack([s, s, zeros, zeros], dim=-1)


def logdet(P, det_floor: float = 1e-30, rel: float = 1e-6):
    return torch.log(torch.clamp(det(load_diag(P, rel)), min=det_floor))


def herm_apply(P, x0, x1):
    """y = P x for packed Hermitian P and complex x components."""
    b = _cplx(P[..., 2], P[..., 3])
    y0 = P[..., 0] * x0 + b * x1
    y1 = b.conj() * x0 + P[..., 1] * x1
    return y0, y1


def gen_outer(x0, x1, y0, y1):
    """Packed general (..., 8) for the outer product x y^H."""
    m00 = x0 * y0.conj()
    m01 = x0 * y1.conj()
    m10 = x1 * y0.conj()
    m11 = x1 * y1.conj()
    return torch.stack([_re(m00), _im(m00), _re(m01), _im(m01),
                        _re(m10), _im(m10), _re(m11), _im(m11)], dim=-1)


def herm_sq(P):
    """Packed Hermitian P @ P for Hermitian P."""
    a, d = P[..., 0], P[..., 1]
    br, bi = P[..., 2], P[..., 3]
    b2 = br * br + bi * bi
    return torch.stack([a * a + b2, d * d + b2,
                        br * (a + d), bi * (a + d)], dim=-1)


def herm_as_gen(P):
    """Packed Hermitian (..., 4) -> packed general (..., 8)."""
    zeros = torch.zeros_like(P[..., 0])
    return torch.stack([P[..., 0], zeros, P[..., 2], P[..., 3],
                        P[..., 2], -P[..., 3], P[..., 1], zeros], dim=-1)


def quadform(P, x0, x1):
    """Real u^H P u for packed Hermitian P and complex u = (x0, x1)."""
    w = x1 * x0.conj()
    return (P[..., 0] * (_re(x0) ** 2 + _im(x0) ** 2)
            + P[..., 1] * (_re(x1) ** 2 + _im(x1) ** 2)
            + 2.0 * (P[..., 2] * _re(w) - P[..., 3] * _im(w)))


def sandwich22(A, P):
    """Packed Hermitian M = A^H P A for complex A (..., 2, 2) and packed
    Hermitian P broadcastable against A's leading axes.

    Used for the sub-source-space posterior metric A^H S^-1 A of full-rank
    components.
    """
    a00, a01 = A[..., 0, 0], A[..., 0, 1]
    a10, a11 = A[..., 1, 0], A[..., 1, 1]
    m00 = quadform(P, a00, a10)
    m11 = quadform(P, a01, a11)
    pa, pd = P[..., 0], P[..., 1]
    b = _cplx(P[..., 2], P[..., 3])
    m01 = (a00.conj() * (pa * a01 + b * a11)
           + a10.conj() * (b.conj() * a01 + pd * a11))
    return torch.stack([m00, m11, _re(m01), _im(m01)], dim=-1)


def herm_from_mixing(A):
    """Packed A @ A^H for a complex mixing matrix A (..., I=2, R).

    This is the spatial covariance R_j. Works for any rank R.
    """
    a = torch.sum(A[..., 0, :].abs() ** 2, dim=-1)
    d = torch.sum(A[..., 1, :].abs() ** 2, dim=-1)
    b = torch.sum(A[..., 0, :] * A[..., 1, :].conj(), dim=-1)
    return pack_herm(a, d, b)


def inv_herm_2x2(H_complex, det_floor: float = 1e-30):
    """Batched 2x2 Hermitian inverse on complex input: (..., 2, 2) -> same."""
    return herm_to_complex(inv(herm_from_complex(H_complex), det_floor))
