"""Operations and bytes of one GEM iteration, from its shapes alone.

Frozen copies, taken from commit 34b280c4 of this repository and not to
follow later changes of the program:

    count_ops, general_ops, _frame_sums, bound,     chip_smoke.py
    the H100 peaks
    estep_ref and its complex helpers               pyfasst_tpu_torch/ops/
                                                    cuda_estep.py
    fb_stats_ref, tw_stats_ref                      ops/cuda_spectral.py
    update_spatial, update_spectral, renormalize    ops/mstep.py, cut to the
                                                    model the configurations
                                                    state: instantaneous real
                                                    rank-1 mixing, one free
                                                    FB/TW NMF chain a source

The counts run on these copies, on meta tensors, at a cell's shapes: never
on the program's own functions, so a roofline share or `gem_mfu` does not
depend on which code the program runs.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import torch

# an H100 SXM's published peaks (NVIDIA's data sheet; 700 W): device
# memory bandwidth and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def count_ops(fn, *args, **kw) -> int:
    """Arithmetic operations of one call of a plain version, counted while
    it runs: each elementwise operation counts its output's elements, each
    sum or mean its input's, a matrix product 2 M K N; views, copies and
    allocations count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    free = {aten.copy_, aten.clone, aten._to_copy, aten.fill_, aten.zero_,
            aten.lift_fresh}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            pkt = func.overloadpacket
            if pkt in (aten.mm, aten.bmm):
                self.ops += 2 * args[0].numel() * args[1].shape[-1]
            elif pkt in (aten.sum, aten.mean):
                self.ops += args[0].numel()
            elif (pkt not in free and torch.Tag.pointwise in func.tags
                  and isinstance(out, torch.Tensor)):
                self.ops += out.numel()
            return out

    with Count() as counter:
        fn(*args, **kw)
    return counter.ops


def bound(tensors, ops):
    """(bound_s, bound_by, bytes): the least time an H100 SXM could take
    for a call that reads each of its inputs once and writes each of its
    outputs once (`tensors`, both) and does `ops` float32 operations: the
    larger of bytes over the memory rate and operations over the float32
    rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


# -- the general E-step's plain version (cuda_estep.estep_ref) ---------------
#
# Complex scalars are (re, im) pairs of tensors; a component may be None,
# meaning exactly zero (the imaginary parts of real mixing).

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


def estep_ref(x4, v, A4, sigma, ranks, ns_inj: bool = False,
              real_cov: bool = False, eps: float = 1e-30,
              no_ll: bool = False):
    """The general E-step kernel's plain version: x4 (B, 4, F, N), v (B, J,
    F, N), A4 (B, J, F, 4 Rmax), sigma (B, F) -> (xi, txs, tss, t4, t7,
    ll) in the kernel's packed layout."""
    B, J, F, N = v.shape
    Rmax = max(ranks)
    x0 = (x4[:, 0], x4[:, 1])
    x1 = (x4[:, 2], x4[:, 3])
    sig = sigma[:, :, None]
    vs = [v[:, j] for j in range(J)]

    def col(j, o):
        return A4[:, j, :, o:o + 1]

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
        a = sig + sum(vs[k] * Ra[k] for k in keep)
        d = sig + sum(vs[k] * Rd[k] for k in keep)
        b = (sum(vs[k] * Rb[k][0] for k in keep),
             None if real_cov else sum(vs[k] * Rb[k][1] for k in keep))
        lin = sum(vs[k] * trR[k] for k in keep)
        quad = 0.5 * sum(vs[k] * vs[l] * Xc[(k, l)]
                         for k in keep for l in keep)
        return a, d, b, sig * sig + sig * lin + quad

    def leave_one_out():
        def others(k, l):
            return torch.tensor([j for j in range(J) if j != k and j != l],
                                dtype=torch.long, device=v.device)

        def lin(terms):
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
        y0 = _cscale(rinv, _csub(_cscale(d, u0), _cmul(b, u1)))
        y1 = _cscale(rinv, _csub(_cscale(a, u1), _cmul(_cconj(b), u0)))
        return y0, y1

    a, d, b, det = mixture(range(J))
    rinv = 1.0 / det
    y0, y1 = herm_apply(a, d, b, rinv, x0, x1)
    tr = torch.clamp(_cdot_conj(x0, y0)[0] + _cdot_conj(x1, y1)[0], min=0.0)
    if ns_inj:
        tr = tr + sig * (a + d) * rinv
    ll = torch.sum(tr if no_ll else torch.log(det) + tr, dim=-1)

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


_HELPERS = SimpleNamespace(_m=_m, _cmul=_cmul, _cconj=_cconj, _cadd=_cadd,
                           _cscale=_cscale, _cdot_conj=_cdot_conj)


def general_ops(inp, ranks, **kw) -> int:
    """Operations of one general E-step on inputs `inp`: those of its plain
    version (count_ops), with its frame sums (Txs, Tss, T7) counted as the
    function needs them rather than as estep_ref forms them."""
    return (count_ops(estep_ref, *inp, ranks, **kw)
            - _frame_sums(_HELPERS, inp, ranks, False, **kw)
            + _frame_sums(_HELPERS, inp, ranks, True, **kw))


def _frame_sums(ce, inp, ranks, need, ns_inj=False, real_cov=False, **_):
    """Operations of the general E-step's frame sums (Txs, Tss, T7) on
    `inp`'s (B, F, N): estep_ref's, in its own forms (need False), or the
    function's (need True; general_ops). Each kind of term is counted once
    with estep_ref's helpers on meta tensors, times the number of (j, k, r,
    s) that take it."""
    B, J, F, N = inp[1].shape
    t = torch.empty((B, F, N), device="meta")
    col = torch.empty((B, F, 1), device="meta")
    row = torch.empty((B, F), device="meta")
    x = w = (t, t)
    z = (t, None) if real_cov else (t, t)
    A, A_row, S = ((c, None) if real_cov else (c, c) for c in (col, row, row))

    def rsum(*parts):
        for p in parts:
            if p is not None:
                torch.sum(p, dim=-1)

    def row_sig(*parts):
        for p in parts:
            if p is not None:
                row * torch.sum(p, dim=-1)

    cols = sum(ranks)
    pairs = cols * cols
    cross = pairs - sum(r * r for r in ranks)
    if not need:
        def txs():
            cw = ce._cconj(w)
            p0, p1 = ce._cmul(x, cw), ce._cmul(x, cw)
            if ns_inj:
                p0 = ce._cadd(p0, ce._cscale(col, z))
                p1 = ce._cadd(p1, ce._cscale(col, z))
            rsum(*(ce._m(t, c) for c in p0 + p1))

        def tss():
            pr = ce._cmul(w, ce._cconj(w))
            if ns_inj:
                zc = ce._cadd(ce._cdot_conj(z, z), ce._cdot_conj(z, z))
                pr = ce._cadd(pr, ce._cscale(col, zc))
            rsum(ce._m(t, pr[0]), ce._m(t, pr[1]))

        def t7():
            m = ce._cadd(ce._cmul(ce._cconj(A), z),
                         ce._cmul(ce._cconj(A), z))
            rsum(ce._m(t, m[0]), ce._m(t, m[1]))
        return (cols * count_ops(txs) + J * J * count_ops(lambda: t * t)
                + pairs * count_ops(tss) + cross * count_ops(t7))

    def scale():
        ce._cscale(t, w)
        ce._cscale(t, z)
        ce._cscale(t, z)

    def txs():
        rsum(*ce._cdot_conj(w, x), *ce._cdot_conj(w, x))
        if ns_inj:
            row_sig(*z, *z)

    def tss():
        rsum(*ce._cdot_conj(w, w))
        if ns_inj:
            row_sig(*ce._cadd(ce._cdot_conj(z, z), ce._cdot_conj(z, z)))

    def t7_frames():
        rsum(*(ce._m(t, p) for p in z + z))

    def t7_row():
        ce._cadd(ce._cdot_conj(A_row, S), ce._cdot_conj(A_row, S))
    return (cols * (count_ops(scale) + count_ops(txs))
            + (2 * pairs - cross) // 2 * count_ops(tss)
            + (J - 1) * cols * count_ops(t7_frames)
            + cross * count_ops(t7_row))


# -- the spectral kernels' plain versions (cuda_spectral) --------------------

def _vc(FB, TW, vfloor):
    return torch.maximum(FB @ TW, vfloor[..., None, None])


def fb_stats_ref(xi, FB, TW, vfloor):
    Vc = _vc(FB, TW, vfloor)
    return (xi / (Vc * Vc)) @ TW.mT, (1.0 / Vc) @ TW.mT


def tw_stats_ref(xi, FB, TW, vfloor):
    Vc = _vc(FB, TW, vfloor)
    return FB.mT @ (xi / (Vc * Vc)), FB.mT @ (1.0 / Vc)


# -- the M-step and renormalize (mstep.py), rank-1 instantaneous mixing, one
# free FB/TW chain a source ---------------------------------------------------

UPD_MIN, UPD_MAX = 1e-5, 1e5


def _mul_upd(factor, num_term, den_term, eps):
    upd = torch.clamp(num_term / torch.clamp(den_term, min=eps),
                      UPD_MIN, UPD_MAX)
    return torch.clamp(factor * upd, min=eps)


def update_spatial(A, Txs, Tss, T4, T7, sigma, eps: float = 1e-12):
    """One Gauss-Seidel sweep of the pooled instantaneous solve. A: J real
    (B, I, 1); Txs[j] complex (B, F, I, 1); Tss[j][k], T7[j][k] complex
    (B, F, 1, 1); T4[j] (B, F); sigma (B, F). Returns the new A."""
    F = Txs[0].shape[1]
    J = len(A)
    cdt = Txs[0].dtype
    A_all = [a.to(cdt)[:, None].expand(-1, F, -1, -1) for a in A]
    new = list(A)
    w = 1.0 / torch.clamp(sigma, min=1e-30)
    w = w / torch.mean(w, -1, keepdim=True)
    for j in range(J):
        target = Txs[j]
        for k in range(J):
            if k == j:
                continue
            target = target - A_all[k] @ (Tss[k][j] - T7[k][j])
        Rss = Tss[j][j] + T4[j][..., None, None].to(cdt)
        wf = w[:, :, None, None]
        target_p = torch.sum(wf * target, 1).real
        Rss_p = torch.sum(wf * Rss, 1).real
        tr = torch.diagonal(Rss_p, dim1=-2, dim2=-1).sum(-1)
        Rss_p = Rss_p + eps * tr[:, None, None] * torch.eye(
            1, dtype=Rss_p.dtype, device=Rss_p.device)
        new[j] = torch.linalg.solve_ex(Rss_p.mT, target_p.mT,
                                       check_errors=False)[0].mT
        A_all[j] = new[j].to(cdt)[:, None].expand(-1, F, -1, -1)
    return new


def update_spectral(FB, TW, xi, v, eps: float = 1e-30):
    """IS-NMF multiplicative updates of each source's FB then TW, V
    refreshed between them. FB[j] (B, F, K), TW[j] (B, K, N), xi (B, J, F,
    N), v (B, J, F, N) the E-step's source powers."""
    FB, TW = list(FB), list(TW)
    for j in range(len(FB)):
        P, V = xi[:, j], v[:, j]
        vk = FB[j] @ TW[j]
        v_floor = 1e-12 * torch.mean(P, (-2, -1), keepdim=True) + eps
        for idx in (0, 2):
            Vc = torch.maximum(V, v_floor)
            num = P / (Vc * Vc)
            den = 1.0 / Vc
            if idx == 0:
                FB[j] = _mul_upd(FB[j], num @ TW[j].mT, den @ TW[j].mT, eps)
            else:
                TW[j] = _mul_upd(TW[j], FB[j].mT @ num, FB[j].mT @ den, eps)
            vk_new = FB[j] @ TW[j]
            V = V - vk + vk_new
            vk = vk_new
    return FB, TW


def renormalize(A, FB, TW):
    """Each A_j to unit mean power, the power into FB_j; FB_j's column sums
    pushed into TW_j."""
    A, FB, TW = list(A), list(FB), list(TW)
    for j in range(len(A)):
        norm = torch.clamp(torch.sum(A[j] ** 2, dim=(1, 2)) / A[j].shape[1],
                           min=1e-30)
        A[j] = A[j] / torch.sqrt(norm).reshape(-1, 1, 1)
        FB[j] = FB[j] * norm[:, None, None]
    for j in range(len(FB)):
        s = torch.clamp(torch.sum(FB[j], dim=-2), min=1e-30)
        FB[j] = FB[j] / s[:, None, :]
        TW[j] = TW[j] * s[:, :, None]
    return A, FB, TW


# -- a cell's figures ----------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def estep_bound(B, J, F, N, ranks=None, real_cov=True, ns_inj=False):
    """(bound_s, bound_by, bytes, ops) of one general E-step at (B, J, F,
    N), inputs and outputs in the kernel's packed layout (the shapes of
    chip_smoke.bound_table)."""
    ranks = tuple(ranks or (1,) * J)
    R = max(ranks)
    inp = [_meta(B, 4, F, N), _meta(B, J, F, N), _meta(B, J, F, 4 * R),
           _meta(B, F)]
    outs = [_meta(B, J, F, N), _meta(B, J, F, 4 * R),
            _meta(B, J, J, F, 2 * R * R), _meta(B, J, F, 4),
            _meta(B, J, J, F, 2 * R * R), _meta(B, F)]
    ops = general_ops(inp, ranks, ns_inj=ns_inj, real_cov=real_cov)
    return bound(inp + outs, ops) + (ops,)


def spectral_bound(B, J, F, N, K):
    """(bound_s, bytes, ops) of one fb_stats and one tw_stats call
    together, each bounded on its own and the two bounds added."""
    xi, FB, TW, vf = (_meta(B, J, F, N), _meta(B, J, F, K),
                      _meta(B, J, K, N), _meta(B, J))
    total_s = total_b = total_ops = 0
    for ref, out in ((fb_stats_ref, (B, J, F, K)),
                     (tw_stats_ref, (B, J, K, N))):
        ops = count_ops(ref, xi, FB, TW, vf)
        s, _, nbytes = bound([xi, FB, TW, vf, _meta(*out), _meta(*out)], ops)
        total_s, total_b, total_ops = (total_s + s, total_b + nbytes,
                                       total_ops + ops)
    return total_s, total_b, total_ops


def gem_iteration_ops(B, J, F, N, K, estep_ops, I=2) -> dict:
    """Operations of one GEM iteration by part, on the plain copies above:
    the sources' powers v = FB TW, the E-step (`estep_ops`, general_ops'
    count from estep_bound), the spatial
    and spectral M-steps and renormalize. The same count whichever code
    runs the iteration."""
    c64 = torch.complex64
    FB = [_meta(B, F, K) for _ in range(J)]
    TW = [_meta(B, K, N) for _ in range(J)]
    A = [_meta(B, I, 1) for _ in range(J)]
    sigma = _meta(B, F)
    xi, v = _meta(B, J, F, N), _meta(B, J, F, N)
    Txs = [_meta(B, F, I, 1, dtype=c64) for _ in range(J)]
    Tss = [[_meta(B, F, 1, 1, dtype=c64) for _ in range(J)]
           for _ in range(J)]
    T7 = [[_meta(B, F, 1, 1, dtype=c64) for _ in range(J)]
          for _ in range(J)]
    T4 = [_meta(B, F) for _ in range(J)]
    out = {
        "powers": count_ops(lambda: [f @ t for f, t in zip(FB, TW)]),
        "estep": estep_ops,
        "spatial": count_ops(update_spatial, A, Txs, Tss, T4, T7, sigma),
        "spectral": count_ops(update_spectral, FB, TW, xi, v),
        "renormalize": count_ops(renormalize, A, FB, TW),
    }
    out["total"] = sum(out.values())
    return out


def cell_figures(B, J, F, N, K) -> dict:
    """Every shape-derived figure the per-layer readers use, for one cell."""
    e_s, e_by, e_bytes, e_ops = estep_bound(B, J, F, N)
    s_s, s_bytes, s_ops = spectral_bound(B, J, F, N, K)
    return {"estep_bound_s": e_s, "estep_bound_by": e_by,
            "estep_bytes": e_bytes, "estep_ops": e_ops,
            "spectral_bound_s": s_s, "spectral_bytes": s_bytes,
            "spectral_ops": s_ops,
            "gem_ops": gem_iteration_ops(B, J, F, N, K, e_ops)}


if __name__ == "__main__":      # python3 benchmark/harness/counts.py
    print(json.dumps(cell_figures(8, 2, 513, 863, 8), indent=1))
