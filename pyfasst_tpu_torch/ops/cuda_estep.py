"""Fused E-step kernel for I = 2, rank-1 sources with real mixing.

Port of pyfasst_tpu/ops/pallas_estep.py (pack_x4, pallas_estep,
pallas_suff_stats) for the main path's variant: ranks (1, ..., 1),
real_cov=True, no noise injection, exact divides. The kernel is CUDA C++
for sm_90a (csrc/estep.cu), built by ops/_build.py and bound with ctypes.

``estep_r1_real`` launches it on a CUDA tensor and runs the plain PyTorch
version ``estep_r1_real_ref`` on a CPU tensor; there is no fallback on
CUDA. ``LAUNCHES`` counts kernel launches. ``suff_stats_cuda`` returns an
estep.SuffStats laid out as pallas_suff_stats lays it out.

Complex mixing (real_cov=False), rank 2, noise injection and fast_recip are
kernel variants still to port: they raise NotImplementedError.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pyfasst_tpu_torch.ops.estep import SuffStats

LAUNCHES = 0
"""Launches of the CUDA kernel in this process (comparison launches
included; callers reset it before the run they want to count)."""


def pack_x4(X: torch.Tensor) -> torch.Tensor:
    """(B, F, N, 2) complex STFT -> the kernel's (B, 4, F, N) float layout
    [Re x0, Im x0, Re x1, Im x1]. X is constant across GEM iterations:
    pack once per run, outside the loop."""
    X = X.resolve_conj()
    return torch.stack([X[..., 0].real, X[..., 0].imag,
                        X[..., 1].real, X[..., 1].imag], dim=1).contiguous()


def mixing_columns(A_conv) -> torch.Tensor:
    """Real mixing columns (B, J, F, 2) from per-source complex (B, F, 2, 1)
    mixing whose imaginary parts are zero (instantaneous models)."""
    return torch.stack([A.resolve_conj()[..., 0].real for A in A_conv],
                       dim=1).contiguous()


def estep_r1_real_ref(x4, v, A, sigma, eps: float = 1e-30):
    """Plain PyTorch version of the kernel: same inputs, same outputs.

    x4 (B, 4, F, N), v (B, J, F, N), A (B, J, F, 2), sigma (B, F). Returns
    (xi, txs, tss, t4, t7, ll) in the kernel's packed layout (see
    csrc/estep.cu). It follows _make_kernel's rank-1 real-mixing algebra
    (coef = 1 / (1 + v M00)), not estep.compute_suff_stats' form.
    """
    B, J, F, N = v.shape
    x0r, x0i, x1r, x1i = (x4[:, c] for c in range(4))       # (B, F, N)
    sig = sigma[:, :, None]                                  # (B, F, 1)
    a0 = [A[:, j, :, 0][..., None] for j in range(J)]        # (B, F, 1)
    a1 = [A[:, j, :, 1][..., None] for j in range(J)]
    Ra = [a0[j] * a0[j] for j in range(J)]
    Rd = [a1[j] * a1[j] for j in range(J)]
    Rb = [a0[j] * a1[j] for j in range(J)]
    trR = [Ra[j] + Rd[j] for j in range(J)]
    Xc = [[(a0[j] * a1[k] - a1[j] * a0[k]) ** 2 for k in range(J)]
          for j in range(J)]
    vs = [v[:, j] for j in range(J)]

    def sums(keep):
        """Sigma entries and det over the sources in `keep`."""
        sa = sum(vs[k] * Ra[k] for k in keep)
        sd = sum(vs[k] * Rd[k] for k in keep)
        sb = sum(vs[k] * Rb[k] for k in keep)
        lin = sum(vs[k] * trR[k] for k in keep)
        quad = sum(vs[k] * vs[l] * Xc[k][l] for k in keep for l in keep)
        det = sig * sig + sig * lin + 0.5 * quad
        return sig + sa, sig + sd, sb, det

    a, d, b, det = sums(range(J))
    rinv = 1.0 / det
    y0r, y0i = rinv * (d * x0r - b * x1r), rinv * (d * x0i - b * x1i)
    y1r, y1i = rinv * (a * x1r - b * x0r), rinv * (a * x1i - b * x0i)
    tr = torch.clamp((x0r * y0r + x0i * y0i) + (x1r * y1r + x1i * y1i),
                     min=0.0)
    ll = torch.sum(torch.log(det) + tr, dim=-1)              # (B, F)

    wr = [a0[j] * y0r + a1[j] * y1r for j in range(J)]
    wi = [a0[j] * y0i + a1[j] * y1i for j in range(J)]
    u0 = [rinv * (d * a0[j] - b * a1[j]) for j in range(J)]
    u1 = [rinv * (a * a1[j] - b * a0[j]) for j in range(J)]

    xi, txs, t4 = [], [], []
    for j in range(J):
        trCR = wr[j] * wr[j] + wi[j] * wi[j]
        aS, dS, bS, detS = sums([k for k in range(J) if k != j])
        rinvS = 1.0 / detS
        z0 = rinvS * (dS * a0[j] - bS * a1[j])
        z1 = rinvS * (aS * a1[j] - bS * a0[j])
        M00 = a0[j] * z0 + a1[j] * z1
        den = 1.0 + vs[j] * M00
        coef = 1.0 / den
        t4.append(torch.sum(vs[j] / den, dim=-1))
        xi.append(torch.clamp(vs[j] * vs[j] * trCR + vs[j] * coef, min=eps))
        p0r = x0r * wr[j] + x0i * wi[j]
        p0i = x0i * wr[j] - x0r * wi[j]
        p1r = x1r * wr[j] + x1i * wi[j]
        p1i = x1i * wr[j] - x1r * wi[j]
        txs.append(torch.stack([torch.sum(vs[j] * p, dim=-1)
                                for p in (p0r, p0i, p1r, p1i)], dim=-1))
    zero = torch.zeros_like(t4[0])
    tss = torch.empty((B, J, J, F, 2), dtype=v.dtype, device=v.device)
    t7 = torch.zeros((B, J, J, F, 2), dtype=v.dtype, device=v.device)
    for j in range(J):
        for k in range(J):
            vv = vs[j] * vs[k]
            re = wr[j] * wr[k] + wi[j] * wi[k]
            im = wi[j] * wr[k] - wr[j] * wi[k]
            tss[:, j, k, :, 0] = torch.sum(vv * re, dim=-1)
            tss[:, j, k, :, 1] = torch.sum(vv * im, dim=-1)
            if k != j:
                m = a0[j] * u0[k] + a1[j] * u1[k]
                t7[:, j, k, :, 0] = torch.sum(vv * m, dim=-1)
    return (torch.stack(xi, dim=1), torch.stack(txs, dim=1), tss,
            torch.stack([torch.stack([t, zero, zero, zero], dim=-1)
                         for t in t4], dim=1),
            t7, ll)


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def estep_r1_real(x4, v, A, sigma, eps: float = 1e-30):
    """The E-step kernel on a CUDA tensor, its plain version on a CPU one.

    Shapes and outputs as estep_r1_real_ref. On CUDA every input must be
    float32, contiguous and on one device; the outputs are allocated here
    and the kernel runs on the current stream.
    """
    if v.device.type == "cpu":
        return estep_r1_real_ref(x4, v, A, sigma, eps)
    if v.device.type != "cuda":
        raise NotImplementedError(f"no E-step kernel for device {v.device}")
    B, J, F, N = v.shape
    dev = v.device
    _check("x4", x4, (B, 4, F, N), dev)
    _check("v", v, (B, J, F, N), dev)
    _check("A", A, (B, J, F, 2), dev)
    _check("sigma", sigma, (B, F), dev)
    if J not in (2, 3):
        raise NotImplementedError(
            f"the E-step kernel is built for J = 2 and 3 sources, got {J}")
    from pyfasst_tpu_torch.ops import _build

    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    xi = torch.empty((B, J, F, N), **f32)
    txs = torch.empty((B, J, F, 4), **f32)
    tss = torch.empty((B, J, J, F, 2), **f32)
    t4 = torch.empty((B, J, F, 4), **f32)
    t7 = torch.empty((B, J, J, F, 2), **f32)
    ll = torch.empty((B, F), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pyfasst_estep_r1_real(
            x4.data_ptr(), v.data_ptr(), A.data_ptr(), sigma.data_ptr(),
            xi.data_ptr(), txs.data_ptr(), tss.data_ptr(), t4.data_ptr(),
            t7.data_ptr(), ll.data_ptr(), B, J, F, N, ctypes.c_float(eps),
            stream)
    if err != 0:
        raise RuntimeError(f"E-step kernel launch failed: cudaError_t {err}")
    global LAUNCHES
    LAUNCHES += 1
    return xi, txs, tss, t4, t7, ll


def kernel_eligible(ranks: Tuple[int, ...], real_cov: bool,
                    noise_inject: bool, dtype, fast_recip: bool,
                    I: int) -> str:
    """'' when the kernel computes this E-step, else why it does not."""
    if I != 2:
        return f"I = {I} channels (general-I engine, ROADMAP item 9)"
    if any(r != 1 for r in ranks):
        return f"ranks {tuple(ranks)} (kernel 1 variant c, rank 2)"
    if not real_cov:
        return "complex mixing (kernel 1 variant b)"
    if noise_inject:
        return "ann_ns_inj noise injection (kernel 1 variant d)"
    if fast_recip:
        return "fast_recip (kernel 1 variant e)"
    if dtype != torch.float32:
        return f"dtype {dtype} (the kernel is float32)"
    if len(ranks) not in (2, 3):
        return f"J = {len(ranks)} sources (kernel built for J = 2, 3)"
    return ""


def suff_stats_cuda(X, v, Rj, sigma, ranks, A_conv, eps: float = 1e-30,
                    noise_inject: bool = False, x4=None,
                    real_cov: bool = False,
                    fast_recip: bool = False) -> SuffStats:
    """Drop-in for estep.compute_suff_stats through the kernel.

    Pass x4 = pack_x4(X), computed once, when calling inside a loop; X is
    then ignored. Rj is unused: the kernel derives R_j from the mixing
    columns. Raises NotImplementedError for a variant the kernel does not
    compute.
    """
    why = kernel_eligible(ranks, real_cov, noise_inject, v.dtype, fast_recip,
                          2 if x4 is not None else X.shape[-1])
    if why:
        raise NotImplementedError(f"E-step kernel variant not ported: {why}")
    if x4 is None:
        x4 = pack_x4(X)
    A = mixing_columns(A_conv)
    xi, txs, tss, t4, t7, ll = estep_r1_real(
        x4, v.contiguous(), A, sigma.contiguous(), eps)
    B, J, F, _ = v.shape

    def c_(re, im):
        return torch.complex(re, im)

    Txs = tuple(torch.stack([c_(txs[:, j, :, 0], txs[:, j, :, 1]),
                             c_(txs[:, j, :, 2], txs[:, j, :, 3])],
                            dim=2)[..., None] for j in range(J))
    Tss = tuple(tuple(c_(tss[:, j, k, :, 0], tss[:, j, k, :, 1])
                      .reshape(B, F, 1, 1) for k in range(J))
                for j in range(J))
    T7 = tuple(tuple(None if j == k
                     else c_(t7[:, j, k, :, 0], t7[:, j, k, :, 1])
                     .reshape(B, F, 1, 1) for k in range(J))
               for j in range(J))
    T4 = tuple(t4[:, j, :, 0] for j in range(J))
    return SuffStats(xi=xi, Txs=Txs, Tss=Tss, T4=T4, T7=T7,
                     loglik=-ll.sum(dim=-1))
