"""Fused E-step kernels for I = 2 channels, bound with ctypes.

Port of pyfasst_tpu/ops/pallas_estep.py (pack_x4, pallas_estep,
pallas_suff_stats). The kernels are CUDA C++ for sm_90a, built by
ops/_build.py:

    estep_r1_real   csrc/estep.cu          variant a: ranks all 1, real
                                           mixing, no noise injection;
                                           J = 2, 3 (the main path)
    estep_general   csrc/estep_general.cuh variants b, c, d and their
                    (estep_j{2..16}.cu)    combinations: complex mixing,
                                           ranks in {1, 2} per source,
                                           'ann_ns_inj'; J = 2 to 16 (and
                                           variant a's model at J = 4-16)
                    csrc/estep_many.cu     the same at J = 1 and any J >=
                                           17, J an argument of the launch
                                           (fused up to J = 48-93 by rank
                                           and mixing, chunked past it;
                                           many_plan)

Both take the flags fast_recip (variant e: approximate reciprocals with a
Newton step, csrc/recip.cuh) and no_ll (variant f: the loglik without
log det Sigma_x). Each launches its kernel on a CUDA tensor and runs its
plain PyTorch version (``estep_r1_real_ref``, ``estep_ref``) on a CPU
tensor; there is no fallback on CUDA. The plain versions divide exactly
whatever fast_recip says, as the Pallas kernel in interpret mode does
(pallas_estep.py:448). ``LAUNCHES`` counts kernel launches, and
``VARIANT_LAUNCHES`` counts them by the variant each launch computes (one
launch of a complex rank-2 E-step with fast_recip counts for b, c and e).
``suff_stats_cuda`` returns an estep.SuffStats laid out as
pallas_suff_stats lays it out.

Not computed on CUDA: float64, I != 2, ranks past 2 and more than
MAX_SOURCES sources: kernel_eligible names them and suff_stats_cuda raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pyfasst_tpu_torch.ops.estep import SuffStats

LAUNCHES = 0
"""Launches of the CUDA kernels in this process (comparison launches
included; callers reset it before the run they want to count). A call
made while a CUDA graph is being captured records the kernel and does not
launch it, so it does not count; nor do the graph's replays."""

VARIANT_LAUNCHES = {"a": 0, "b": 0, "c": 0, "d": 0, "e": 0, "f": 0}
"""Launches by kernel-1 variant: a (estep_r1_real, or the general kernel
on real rank-1 mixing without noise injection), b (complex mixing),
c (a rank-2 source), d (noise injection), e (fast_recip), f (no_ll)."""

GENERAL_J = tuple(range(2, 17))
"""Source counts with a compile-time instantiation of the general kernel
(one translation unit each, csrc/estep_j{J}.cu). Every other J, one source
and J >= 17, goes to csrc/estep_many.cu, which takes J at run time."""

MAX_SOURCES = 4096
"""The most sources csrc/estep_many.cu takes: their ranks reach the card
as a bit mask of this many bits in the launch's arguments. Past some
thousand sources the outputs (J^2 frame sums a row) outgrow the card's
memory at any real width first."""


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


def estep_r1_real_ref(x4, v, A, sigma, eps: float = 1e-30,
                      no_ll: bool = False):
    """Plain PyTorch version of the kernel: same inputs, same outputs.

    x4 (B, 4, F, N), v (B, J, F, N), A (B, J, F, 2), sigma (B, F). Returns
    (xi, txs, tss, t4, t7, ll) in the kernel's packed layout (see
    csrc/estep.cu). It follows _make_kernel's rank-1 real-mixing algebra
    (coef = 1 / (1 + v M00)), not estep.compute_suff_stats' form. no_ll
    leaves log det Sigma_x out of ll.
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
    ll = torch.sum(tr if no_ll else torch.log(det) + tr, dim=-1)  # (B, F)

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


def estep_r1_real(x4, v, A, sigma, eps: float = 1e-30,
                  fast_recip: bool = False, no_ll: bool = False):
    """The E-step kernel on a CUDA tensor, its plain version on a CPU one.

    Shapes and outputs as estep_r1_real_ref. On CUDA every input must be
    float32, contiguous and on one device; the outputs, and the scratch of
    a launch that splits few rows' frames (segments), are allocated here
    and the kernel runs on the current stream. fast_recip (variant e) takes
    the kernel's approximate reciprocals; no_ll (variant f) as in
    estep_r1_real_ref.
    """
    if v.device.type == "cpu":
        return estep_r1_real_ref(x4, v, A, sigma, eps, no_ll)
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
    # few rows: the kernel splits their frames, its segments' sums in here
    words = lib.pyfasst_estep_r1_real_workspace(B, J, F, N)
    ws = torch.empty((words,), **f32) if words > 0 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pyfasst_estep_r1_real(
            x4.data_ptr(), v.data_ptr(), A.data_ptr(), sigma.data_ptr(),
            xi.data_ptr(), txs.data_ptr(), tss.data_ptr(), t4.data_ptr(),
            t7.data_ptr(), ll.data_ptr(),
            None if ws is None else ws.data_ptr(), B, J, F, N,
            ctypes.c_float(eps), int(fast_recip), int(no_ll), stream)
    if err != 0:
        raise RuntimeError(f"E-step kernel launch failed: cudaError_t {err}")
    _count(["a"], fast_recip, no_ll)
    return xi, txs, tss, t4, t7, ll


def _count(variants, fast_recip: bool, no_ll: bool) -> None:
    global LAUNCHES
    if torch.cuda.is_current_stream_capturing():
        return  # recorded into a CUDA graph, not launched
    LAUNCHES += 1
    for name in (variants + (["e"] if fast_recip else [])
                 + (["f"] if no_ll else [])):
        VARIANT_LAUNCHES[name] += 1


# -- the general kernel: variants b (complex), c (rank 2), d (ns_inj) ---------
#
# Complex scalars are (re, im) pairs of tensors; a component may be None,
# meaning exactly zero (the imaginary parts of real mixing and of all that
# derives from it), as in pallas_estep.py's symbolic-zero algebra.

def _m(a, b):
    return None if a is None or b is None else a * b


def _na(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _ns(a, b):
    if b is None:
        return a
    if a is None:
        return -b
    return a - b


def _cmul(x, y):
    return (_ns(_m(x[0], y[0]), _m(x[1], y[1])),
            _na(_m(x[0], y[1]), _m(x[1], y[0])))


def _cconj(x):
    return (x[0], None if x[1] is None else -x[1])


def _cadd(x, y):
    return (_na(x[0], y[0]), _na(x[1], y[1]))


def _csub(x, y):
    return (_ns(x[0], y[0]), _ns(x[1], y[1]))


def _cscale(s, x):
    return (_m(s, x[0]), _m(s, x[1]))


def _cabs2(x):
    return _na(_m(x[0], x[0]), _m(x[1], x[1]))


def _cdot_conj(x, y):
    """conj(x) * y."""
    return (_na(_m(x[0], y[0]), _m(x[1], y[1])),
            _ns(_m(x[0], y[1]), _m(x[1], y[0])))


def estep_ref(x4, v, A4, sigma, ranks: Tuple[int, ...],
              ns_inj: bool = False, real_cov: bool = False,
              eps: float = 1e-30, no_ll: bool = False):
    """Plain PyTorch version of the general kernel: same inputs, outputs.

    x4 (B, 4, F, N), v (B, J, F, N), A4 (B, J, F, 4 Rmax) with per column
    r [Re A0r, Im A0r, Re A1r, Im A1r] (zero past the source's rank),
    sigma (B, F). Returns (xi, txs, tss, t4, t7, ll) in the packed layout
    of csrc/estep_general.cuh. It follows _make_kernel
    (pallas_estep.py:108-362) term by term, with the clip axis and with xi
    already floored at eps; no_ll leaves log det Sigma_x out of ll.
    """
    B, J, F, N = v.shape
    Rmax = max(ranks)
    x0 = (x4[:, 0], x4[:, 1])
    x1 = (x4[:, 2], x4[:, 3])
    sig = sigma[:, :, None]                                  # (B, F, 1)
    vs = [v[:, j] for j in range(J)]                         # (B, F, N)

    def col(j, o):
        return A4[:, j, :, o:o + 1]                          # (B, F, 1)

    Acol = [[((col(j, 4 * r), None if real_cov else col(j, 4 * r + 1)),
              (col(j, 4 * r + 2), None if real_cov else col(j, 4 * r + 3)))
             for r in range(ranks[j])] for j in range(J)]

    Ra = [sum(_cabs2(Acol[j][r][0]) for r in range(ranks[j]))
          for j in range(J)]
    Rd = [sum(_cabs2(Acol[j][r][1]) for r in range(ranks[j]))
          for j in range(J)]
    Rb = []
    for j in range(J):
        prods = [_cmul(Acol[j][r][0], _cconj(Acol[j][r][1]))
                 for r in range(ranks[j])]
        Rb.append((sum(p[0] for p in prods),
                   None if real_cov else sum(p[1] for p in prods)))
    trR = [Ra[j] + Rd[j] for j in range(J)]
    Xc = {}
    for j in range(J):
        for k in range(J):
            acc = None
            for r in range(ranks[j]):
                for s in range(ranks[k]):
                    c = _csub(_cmul(Acol[j][r][0], Acol[k][s][1]),
                              _cmul(Acol[j][r][1], Acol[k][s][0]))
                    acc = _na(acc, _cabs2(c))
            Xc[(j, k)] = acc

    def mixture(keep):
        """Entries a, d, b and the subtract-free det of sig I + sum over
        `keep` of v_k R_k."""
        a = sig + sum(vs[k] * Ra[k] for k in keep)
        d = sig + sum(vs[k] * Rd[k] for k in keep)
        b = (sum(vs[k] * Rb[k][0] for k in keep),
             None if real_cov else sum(vs[k] * Rb[k][1] for k in keep))
        lin = sum(vs[k] * trR[k] for k in keep)
        quad = 0.5 * sum(vs[k] * vs[l] * Xc[(k, l)]
                         for k in keep for l in keep)
        return a, d, b, sig * sig + sig * lin + quad

    def leave_one_out():
        """mixture([k for k in range(J) if k != j]) for every j at once,
        each entry stacked over j: the same sums term by term in the same
        order, each term formed once and added to the sums that take it,
        in J^2 operations on (J, B, F, N) tensors rather than J^3 on
        (B, F, N)."""
        def others(k, l):                       # the j that take term (k, l)
            return torch.tensor([j for j in range(J) if j != k and j != l],
                                dtype=torch.long, device=v.device)

        def lin(terms):                                  # sum over k != j
            acc = torch.zeros((J,) + terms[0].shape, dtype=v.dtype,
                              device=v.device)
            for k, t in enumerate(terms):
                acc[others(k, k)] += t
            return acc

        a = sig + lin([vs[k] * Ra[k] for k in range(J)])
        d = sig + lin([vs[k] * Rd[k] for k in range(J)])
        b = (lin([vs[k] * Rb[k][0] for k in range(J)]),
             None if real_cov else lin([vs[k] * Rb[k][1] for k in range(J)]))
        lin_tr = lin([vs[k] * trR[k] for k in range(J)])
        quad = torch.zeros_like(lin_tr)
        for k in range(J):
            for l in range(J):
                quad[others(k, l)] += vs[k] * vs[l] * Xc[(k, l)]
        return a, d, b, sig * sig + sig * lin_tr + 0.5 * quad

    def herm_apply(a, d, b, rinv, u0, u1):
        """Sigma^-1 (u0, u1) via the adjugate [d, -b; -conj(b), a]."""
        y0 = _cscale(rinv, _csub(_cscale(d, u0), _cmul(b, u1)))
        y1 = _cscale(rinv, _csub(_cscale(a, u1), _cmul(_cconj(b), u0)))
        return y0, y1

    a, d, b, det = mixture(range(J))
    rinv = 1.0 / det
    y0, y1 = herm_apply(a, d, b, rinv, x0, x1)
    tr = torch.clamp(_cdot_conj(x0, y0)[0] + _cdot_conj(x1, y1)[0], min=0.0)
    if ns_inj:
        # 'ann_ns_inj': observed covariance becomes x x^H + sigma I
        tr = tr + sig * (a + d) * rinv
    ll = torch.sum(tr if no_ll else torch.log(det) + tr, dim=-1)  # (B, F)

    w = [[_cadd(_cmul(_cconj(Acol[j][r][0]), y0),
                _cmul(_cconj(Acol[j][r][1]), y1))
          for r in range(ranks[j])] for j in range(J)]
    sxiA = [[herm_apply(a, d, b, rinv, Acol[j][r][0], Acol[j][r][1])
             for r in range(ranks[j])] for j in range(J)]

    like = dict(dtype=v.dtype, device=v.device)
    zero = torch.zeros((B, F), **like)

    def rsum(t):
        return zero if t is None else torch.sum(t, dim=-1)

    loo_a, loo_d, loo_b, loo_det = leave_one_out()
    xi = torch.empty((B, J, F, N), **like)
    txs = torch.zeros((B, J, F, 4 * Rmax), **like)
    t4 = torch.zeros((B, J, F, 4), **like)
    for j in range(J):
        trCR = sum(_cabs2(w[j][r]) for r in range(ranks[j]))
        if ns_inj:
            trCR = trCR + sig * sum(
                _cabs2(sxiA[j][r][0]) + _cabs2(sxiA[j][r][1])
                for r in range(ranks[j]))
        aS, dS, detS = loo_a[j], loo_d[j], loo_det[j]
        bS = (loo_b[0][j], None if loo_b[1] is None else loo_b[1][j])
        rinvS = 1.0 / detS
        sjA = [herm_apply(aS, dS, bS, rinvS, Acol[j][s][0], Acol[j][s][1])
               for s in range(ranks[j])]
        M = [[_cadd(_cmul(_cconj(Acol[j][r][0]), sjA[s][0]),
                    _cmul(_cconj(Acol[j][r][1]), sjA[s][1]))
              for s in range(ranks[j])] for r in range(ranks[j])]
        if ranks[j] == 1:
            den = 1.0 + vs[j] * M[0][0][0]
            coef = 1.0 / den
            t4[:, j, :, 0] = rsum(vs[j] / den)
        else:
            # G = I_2 + v M (Hermitian PD, det >= 1): closed-form inverse
            g00 = 1.0 + vs[j] * M[0][0][0]
            g11 = 1.0 + vs[j] * M[1][1][0]
            g01 = _cscale(vs[j], M[0][1])
            dG = torch.clamp(g00 * g11 - _cabs2(g01), min=1.0)
            rG = 1.0 / dG
            coef = (g00 + g11) * rG
            t4[:, j, :, 0] = rsum(vs[j] * g11 * rG)
            t4[:, j, :, 1] = rsum(vs[j] * g00 * rG)
            t4[:, j, :, 2] = rsum(_m(_m(-vs[j], g01[0]), rG))
            t4[:, j, :, 3] = rsum(_m(_m(-vs[j], g01[1]), rG))
        xi[:, j] = torch.clamp(
            (vs[j] * vs[j] * trCR + vs[j] * coef) / ranks[j], min=eps)
        for r in range(ranks[j]):
            cw = _cconj(w[j][r])
            p0, p1 = _cmul(x0, cw), _cmul(x1, cw)
            if ns_inj:
                p0 = _cadd(p0, _cscale(sig, sxiA[j][r][0]))
                p1 = _cadd(p1, _cscale(sig, sxiA[j][r][1]))
            for q, comp in enumerate((p0[0], p0[1], p1[0], p1[1])):
                txs[:, j, :, 4 * r + q] = rsum(_m(vs[j], comp))

    tss = torch.zeros((B, J, J, F, 2 * Rmax * Rmax), **like)
    t7 = torch.zeros((B, J, J, F, 2 * Rmax * Rmax), **like)
    for j in range(J):
        for k in range(J):
            vv = vs[j] * vs[k]
            for r in range(ranks[j]):
                for s in range(ranks[k]):
                    i = 2 * (r * ranks[k] + s)
                    pr = _cmul(w[j][r], _cconj(w[k][s]))
                    if ns_inj:
                        zc = _cadd(
                            _cdot_conj(sxiA[j][r][0], sxiA[k][s][0]),
                            _cdot_conj(sxiA[j][r][1], sxiA[k][s][1]))
                        pr = _cadd(pr, _cscale(sig, zc))
                    tss[:, j, k, :, i] = rsum(_m(vv, pr[0]))
                    tss[:, j, k, :, i + 1] = rsum(_m(vv, pr[1]))
                    if j != k:
                        m = _cadd(
                            _cmul(_cconj(Acol[j][r][0]), sxiA[k][s][0]),
                            _cmul(_cconj(Acol[j][r][1]), sxiA[k][s][1]))
                        t7[:, j, k, :, i] = rsum(_m(vv, m[0]))
                        t7[:, j, k, :, i + 1] = rsum(_m(vv, m[1]))
    return xi, txs, tss, t4, t7, ll


def pack_A4(A_conv, ranks: Tuple[int, ...]) -> torch.Tensor:
    """Per-source complex mixing (B, F, 2, R_j) -> the kernel's real
    (B, J, F, 4 Rmax) layout, per column r [Re A0r, Im A0r, Re A1r,
    Im A1r], zero-padded past each source's rank (pallas_suff_stats'
    A4, with the clip axis)."""
    Rmax = max(ranks)
    out = []
    for A, R in zip(A_conv, ranks):
        A = A.resolve_conj()
        cols = torch.stack([A[:, :, 0].real, A[:, :, 0].imag,
                            A[:, :, 1].real, A[:, :, 1].imag],
                           dim=-1)                            # (B, F, R, 4)
        cols = cols.reshape(cols.shape[0], cols.shape[1], 4 * R)
        if R < Rmax:
            cols = torch.nn.functional.pad(cols, (0, 4 * (Rmax - R)))
        out.append(cols)
    return torch.stack(out, dim=1).contiguous()


def estep_general(x4, v, A4, sigma, ranks: Tuple[int, ...],
                  ns_inj: bool = False, real_cov: bool = False,
                  eps: float = 1e-30, fast_recip: bool = False,
                  no_ll: bool = False):
    """The general E-step kernel on a CUDA tensor, its plain version
    (estep_ref) on a CPU one. Shapes and outputs as estep_ref.

    On CUDA every input must be float32, contiguous and on one device, with
    J <= MAX_SOURCES and every rank in {1, 2}; the outputs (and outside
    GENERAL_J the kernel's scratch) are allocated here and the kernel runs
    on the current stream: a compile-time instantiation for J in
    GENERAL_J, csrc/estep_many.cu for any other J. fast_recip (variant e)
    takes the kernel's approximate reciprocals; no_ll (variant f) as in
    estep_ref.
    """
    ranks = tuple(int(r) for r in ranks)
    if v.device.type == "cpu":
        return estep_ref(x4, v, A4, sigma, ranks, ns_inj, real_cov, eps,
                         no_ll)
    if v.device.type != "cuda":
        raise NotImplementedError(f"no E-step kernel for device {v.device}")
    B, J, F, N = v.shape
    Rmax = max(ranks)
    dev = v.device
    if len(ranks) != J:
        raise ValueError(f"{len(ranks)} ranks for J = {J} sources")
    _check("x4", x4, (B, 4, F, N), dev)
    _check("v", v, (B, J, F, N), dev)
    _check("A4", A4, (B, J, F, 4 * Rmax), dev)
    _check("sigma", sigma, (B, F), dev)
    if J > MAX_SOURCES:
        raise NotImplementedError(
            f"the E-step kernel takes at most {MAX_SOURCES} sources (their "
            f"ranks reach the card as a bit mask of that many bits), got "
            f"{J}")
    if any(r not in (1, 2) for r in ranks):
        raise NotImplementedError(f"the E-step kernel takes ranks 1 and 2, "
                                  f"got {ranks}")
    from pyfasst_tpu_torch.ops import _build

    lib = _build.load(_build.library_of(J))
    f32 = dict(dtype=torch.float32, device=dev)
    xi = torch.empty((B, J, F, N), **f32)
    txs = torch.empty((B, J, F, 4 * Rmax), **f32)
    tss = torch.empty((B, J, J, F, 2 * Rmax * Rmax), **f32)
    t4 = torch.empty((B, J, F, 4), **f32)
    t7 = torch.empty((B, J, J, F, 2 * Rmax * Rmax), **f32)
    ll = torch.empty((B, F), **f32)
    outs = (xi.data_ptr(), txs.data_ptr(), tss.data_ptr(), t4.data_ptr(),
            t7.data_ptr(), ll.data_ptr())
    ins = (x4.data_ptr(), v.data_ptr(), A4.data_ptr(), sigma.data_ptr())
    flags = (ctypes.c_float(eps), int(fast_recip), int(no_ll))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if J in GENERAL_J:
        rank_mask = sum(1 << j for j, r in enumerate(ranks) if r == 2)
        with torch.cuda.device(dev):
            err = getattr(lib, f"pyfasst_estep_j{J}")(
                *ins, *outs, B, F, N, rank_mask, Rmax, int(real_cov),
                int(ns_inj), *flags, stream)
    else:
        # the fused route's partial sums of a row's segments (none for one
        # segment), or the chunked route's row constants and a chunk of
        # frames' features (many_plan)
        words = lib.pyfasst_estep_many_workspace(B, J, F, N, Rmax,
                                                 int(real_cov))
        if words < 0:
            raise NotImplementedError(
                f"the E-step kernel cannot take (B, J, F, N) = {(B, J, F, N)}"
                " (a launch's grid past 2^31 blocks)")
        ws = torch.empty((words,), **f32) if words else None
        with torch.cuda.device(dev):
            err = lib.pyfasst_estep_many(
                *ins, *outs, ws.data_ptr() if words else None, B, J, F, N,
                (ctypes.c_int * J)(*ranks), Rmax, int(real_cov), int(ns_inj),
                *flags, stream)
    if err != 0:
        raise RuntimeError(f"E-step kernel launch failed: cudaError_t {err}")
    variants = ([] if real_cov else ["b"]) + (["c"] if Rmax == 2 else []) \
        + (["d"] if ns_inj else [])
    _count(variants or ["a"], fast_recip, no_ll)
    return xi, txs, tss, t4, t7, ll


def many_plan(B: int, J: int, F: int, N: int, rmax: int,
              real_cov: bool) -> dict:
    """How csrc/estep_many.cu launches at this shape (its library, so a
    card's machine): "route" "fused" (a block a segment of a row's tiles
    of "frames" = 32, "segments" a row of "tiles" each, "shared_bytes" a
    block) or "chunked" ("frames" a chunk, "segments" the chunks), the
    main kernel's "blocks" and the scratch's "workspace_bytes". Set by
    the shape alone."""
    from pyfasst_tpu_torch.ops import _build
    lib = _build.load("many")
    out = (ctypes.c_longlong * 6)()
    if lib.pyfasst_estep_many_plan(B, J, F, N, rmax, int(real_cov), out):
        raise NotImplementedError(f"the E-step kernel cannot take (B, J, F,"
                                  f" N) = {(B, J, F, N)}")
    return {"route": ("fused", "chunked")[out[0]], "frames": out[1],
            "segments": out[2], "tiles": out[3], "blocks": out[4],
            "shared_bytes": out[5],
            "workspace_bytes": 4 * lib.pyfasst_estep_many_workspace(
                B, J, F, N, rmax, int(real_cov))}


def kernel_eligible(ranks: Tuple[int, ...], real_cov: bool,
                    noise_inject: bool, dtype, fast_recip: bool,
                    I: int) -> str:
    """'' when a kernel computes this E-step, else why none does (naming
    the ROADMAP entry that ports it). Complex mixing, rank 2, mixed ranks,
    noise injection and fast_recip are all computed."""
    if I != 2:
        return (f"I = {I} channels (the kernels are the I = 2 E-step; "
                "gem_step sends other channel counts to the general-I "
                "engine, ops/engine_general.py)")
    if dtype != torch.float32:
        return (f"dtype {dtype} (the kernels are float32; float64 runs on "
                "the CPU, ROADMAP kernel queue 1)")
    if len(ranks) > MAX_SOURCES:
        return (f"J = {len(ranks)} sources (the kernels take at most "
                f"{MAX_SOURCES}: their ranks reach the card as a bit mask "
                "of that many bits)")
    if any(r not in (1, 2) for r in ranks):
        return (f"ranks {tuple(ranks)} (the kernels take ranks 1 and 2; "
                "ROADMAP kernel queue 1)")
    return ""


def suff_stats_cuda(X, v, Rj, sigma, ranks, A_conv, eps: float = 1e-30,
                    noise_inject: bool = False, x4=None,
                    real_cov: bool = False,
                    fast_recip: bool = False) -> SuffStats:
    """Drop-in for estep.compute_suff_stats through the kernels.

    Pass x4 = pack_x4(X), computed once, when calling inside a loop; X is
    then ignored. Rj is unused: the kernels derive R_j from the mixing
    columns. real_cov=True asserts every mixing column is real (the
    instantaneous models). Variant a takes real rank-1 mixing without noise
    injection at J = 2 and 3; the general kernel takes every other eligible
    E-step; fast_recip goes to either. Raises NotImplementedError for one
    that no kernel computes.
    """
    ranks = tuple(int(r) for r in ranks)
    why = kernel_eligible(ranks, real_cov, noise_inject, v.dtype, fast_recip,
                          2 if x4 is not None else X.shape[-1])
    if why:
        raise NotImplementedError(f"E-step kernel variant not ported: {why}")
    if x4 is None:
        x4 = pack_x4(X)
    v = v.contiguous()
    sigma = sigma.contiguous()
    if (real_cov and not noise_inject and all(r == 1 for r in ranks)
            and len(ranks) in (2, 3)):
        out = estep_r1_real(x4, v, mixing_columns(A_conv), sigma, eps,
                            fast_recip=fast_recip)
    else:
        out = estep_general(x4, v, pack_A4(A_conv, ranks), sigma, ranks,
                            ns_inj=noise_inject, real_cov=real_cov, eps=eps,
                            fast_recip=fast_recip)
    return unpack_stats(out, ranks)


def unpack_stats(out, ranks: Tuple[int, ...]) -> SuffStats:
    """The kernels' packed outputs as an estep.SuffStats (complex views by
    actual rank, as pallas_suff_stats:520-543 builds them)."""
    xi, txs, tss, t4, t7, ll = out
    B, J, F, _ = xi.shape
    Rmax = txs.shape[-1] // 4

    def c_(t):
        return torch.complex(t[..., 0], t[..., 1])

    Txs = []
    for j in range(J):
        cols = txs[:, j].reshape(B, F, Rmax, 4)[:, :, :ranks[j]]
        Txs.append(torch.stack([c_(cols[..., 0:2]), c_(cols[..., 2:4])],
                               dim=2))                       # (B, F, 2, R)
    Tss, T7 = [], []
    for j in range(J):
        row_ss, row_7 = [], []
        for k in range(J):
            n = 2 * ranks[j] * ranks[k]
            shape = (B, F, ranks[j], ranks[k], 2)
            row_ss.append(c_(tss[:, j, k, :, :n].reshape(shape)))
            row_7.append(None if j == k
                         else c_(t7[:, j, k, :, :n].reshape(shape)))
        Tss.append(tuple(row_ss))
        T7.append(tuple(row_7))
    T4 = tuple(t4[:, j, :, 0] if ranks[j] == 1 else t4[:, j]
               for j in range(J))
    return SuffStats(xi=xi, Txs=tuple(Txs), Tss=tuple(Tss), T4=T4,
                     T7=tuple(T7), loglik=-ll.sum(dim=-1))
