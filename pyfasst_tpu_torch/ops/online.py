"""Online / streaming GEM (block-wise, with exponential forgetting).

Port of pyfasst_tpu/ops/online.py, with a leading clip axis B on every
tensor (models/streaming.py uses B = 1). The mixture is processed in frame
blocks; exponentially weighted sufficient statistics are carried across
blocks and update the frequency-side parameters (mixing A_j, spectral
patterns FB) while the time activations TW are estimated per block. Memory
stays O(F x block frames), so recordings whose (F, N) plane would not fit
on the card stream through it.

Two entry points run the same block body: ``online_block`` (one block,
carried state; fed by tf.stft.STFT.stream_blocks) and ``run_gem_online``
(a Python loop of online_block over a whole in-memory mixture; the JAX
package's lax.scan). The inner iterations are Python loops that never wait
for the device.

  - A0 (B, J, F, I): rank-1 sources. The E-step of each block is the batch
    engine's: for I = 2 ops/gem.estep_stereo, which on CUDA launches the
    general E-step kernel (complex mixing, variant b; csrc/
    estep_general.cuh) and raises NotImplementedError where no kernel
    computes the E-step; for other I the general-I engine
    (engine_general.suff_stats_general, plain PyTorch on either device).
  - A0 (B, J, F, I, I): full-rank sources, the direct Duong covariance
    M-step on exponentially forgotten accumulators (R_j <- EW-mean of the
    posterior image covariance / v_j), with state.A a Hermitian square
    root of R_j. Its E-step is dense batched complex algebra (solve_ex,
    slogdet) in plain PyTorch on both devices: the JAX package has no
    Pallas kernel for it.

Matrix products run in full float32 (the JAX functions run under
default_matmul_precision("highest")).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pyfasst_tpu_torch.ops import cuda_estep
from pyfasst_tpu_torch.ops.engine_general import suff_stats_general
from pyfasst_tpu_torch.ops.gem import estep_stereo
from pyfasst_tpu_torch.utils.precision import highest_precision


class OnlineState(NamedTuple):
    """Carried across blocks: frequency-side params + EW statistics.

    Rank-1 (A of ndim 4) carries the scalar sub-source statistics.
    Full-rank (A of ndim 5, R == I) reuses the field names for the Duong
    accumulators: txs holds the EW sum of per-frame posterior image
    covariances / v_j, t4 the EW frame count; tss and t7 stay zero (one
    tuple serves both, and the streaming checkpoint stays shape-agnostic).
    """
    A: torch.Tensor         # (B, J, F, I) columns | (B, J, F, I, I) sqrt R_j
    FB: torch.Tensor        # (B, J, F, K) spectral patterns
    txs: torch.Tensor       # (B, J, F, I) EW v x w^H | (B, J, F, I, I) Z_j
    tss: torch.Tensor       # (B, J, J, F) complex EW v_j v_k w_j w_k^H
    t4: torch.Tensor        # (B, J, F) real EW v/(1 + v t) | EW frame count
    t7: torch.Tensor        # (B, J, J, F) complex EW cross posterior cov
    fb_num: torch.Tensor    # (B, J, F, K) EW numerator of the FB update
    fb_den: torch.Tensor    # (B, J, F, K) EW denominator


def _block_estep(Xb, A, FB, TWb, sigma, eps, x4):
    """Rank-1 statistics of one block under the current params: (stats, v).

    I = 2 takes estep_stereo (complex mixing, so on CUDA the general
    kernel's variant b), any other I the general engine."""
    J = FB.shape[1]
    v = torch.einsum("bjfk,bjkn->bjfn", FB, TWb)
    A_conv = tuple(A[:, j][..., None] for j in range(J))  # (B, F, I, 1)
    ranks = (1,) * J
    if Xb.shape[-1] != 2:
        return suff_stats_general(Xb, v, A_conv, sigma, ranks), v
    return estep_stereo(Xb, v, A_conv, ranks, sigma, real_cov=False,
                        eps=eps, x4=x4), v


def _per_clip_mean(t):
    """Mean over every axis but the clip axis, broadcastable against t."""
    return torch.mean(t, dim=tuple(range(1, t.ndim)), keepdim=True)


def _nmf_terms(v, xi, eps):
    """The IS-NMF numerator and denominator planes xi / Vc^2 and 1 / Vc,
    with V floored relative to the observed scale (an absolute eps floor
    overflows float32 under V**-2 for dead components)."""
    Vc = torch.maximum(v, 1e-12 * _per_clip_mean(xi) + eps)
    return xi / (Vc * Vc), 1.0 / Vc


def _tw_update(FB, TWb, v, xi, eps):
    """One multiplicative IS-NMF update of the block's TW, FB fixed."""
    num, den = _nmf_terms(v, xi, eps)
    upd = torch.clamp(
        torch.einsum("bjfk,bjfn->bjkn", FB, num)
        / torch.clamp(torch.einsum("bjfk,bjfn->bjkn", FB, den), min=eps),
        1e-5, 1e5)
    return torch.clamp(TWb * upd, min=eps)


def _fb_accumulate(state, v, xi, TWb, lam, eps):
    """EW-accumulated numerator and denominator of the FB update."""
    num, den = _nmf_terms(v, xi, eps)
    fb_num = lam * state.fb_num + torch.einsum("bjfn,bjkn->bjfk", num, TWb)
    fb_den = lam * state.fb_den + torch.einsum("bjfn,bjkn->bjfk", den, TWb)
    return fb_num, fb_den


def _fullrank_estep(Xb, R, v, sigma):
    """Duong-style posterior statistics of one block, full-rank sources.

    Xb (B, F, N, I) complex mixture block; R (B, J, F, I, I) complex source
    spatial covariances; v (B, J, F, N) source PSDs; sigma (B, F) noise PSD.

    Returns (Z_blk, xi, loglik):
      Z_blk (B, J, F, I, I): sum_n R^_cj(f, n) / v_j(f, n), the Duong
        M-step numerator, formed without dividing by v_j: the posterior
        mean image y_j = v_j R_j Sigma_x^-1 x carries a v_j factor, so
        y y^H / v_j = v_j (R_j w)(R_j w)^H with w = Sigma_x^-1 x (no 0/0 at
        silent frames), and the posterior covariance term is
        R_j - v_j R_j Sigma_x^-1 R_j.
      xi (B, J, F, N): posterior PSD tr(R_j^-1 R^_cj) / I, by trace
        similarity-invariance v_j^2 w^H R_j w + v_j (I - v_j tr(Sigma_x^-1
        R_j)), without an explicit inverse.
      loglik (B,): sum over (f, n) of the block's Gaussian log-density.

    Dense complex algebra with batched small solves (solve_ex: no host
    check per call): full-rank R_j has no structural zeros, and the sigma
    floor bounds cond(Sigma_x) <= tr / sigma.
    """
    B, F, N, I = Xb.shape
    J = R.shape[1]
    eyeI = torch.eye(I, dtype=R.dtype, device=R.device)
    vc = v.to(R.dtype)
    Sx = (torch.einsum("bjfn,bjfac->bfnac", vc, R)
          + sigma[:, :, None, None, None] * eyeI)        # (B, F, N, I, I)
    w = torch.linalg.solve_ex(Sx, Xb[..., None],
                              check_errors=False)[0][..., 0]
    # Sigma_x^-1 R_j for every (j, f, n): (B, J, F, N, I, I)
    SinvR = torch.linalg.solve_ex(
        Sx[:, None].expand(B, J, F, N, I, I),
        R[:, :, :, None].expand(B, J, F, N, I, I), check_errors=False)[0]
    Rw = torch.einsum("bjfac,bfnc->bjfna", R, w)          # R_j w
    Z1 = torch.einsum("bjfn,bjfna,bjfnc->bjfac", vc, Rw, Rw.conj())
    Z2 = N * R - torch.einsum("bjfn,bjfac,bjfnce->bjfae", vc, R, SinvR)
    Z_blk = Z1 + Z2
    Z_blk = 0.5 * (Z_blk + Z_blk.transpose(-1, -2).conj())
    trSinvR = torch.diagonal(SinvR, dim1=-2, dim2=-1).sum(-1).real
    quad = torch.einsum("bfna,bjfna->bjfn", w.conj(), Rw).real
    xi = v * v * quad + v * torch.clamp(I - v * trSinvR, min=0.0)
    xi = torch.clamp(xi / I, min=0.0)
    ld = torch.linalg.slogdet(Sx)[1]                      # (B, F, N)
    quad_x = torch.einsum("bfna,bfna->bfn", Xb.conj(), w).real
    loglik = -(torch.sum(ld, dim=(1, 2)) + torch.sum(quad_x, dim=(1, 2))
               + F * N * I * math.log(math.pi))
    return Z_blk, xi, loglik


def online_init(A0: torch.Tensor, FB0: torch.Tensor) -> OnlineState:
    """Fresh streaming state around initial mixing and pattern guesses.

    A0 complex mixing, either (B, J, F, I) rank-1 or (B, J, F, I, I)
    full-rank (a square root of the initial spatial covariance R_j =
    A_j A_j^H, re-estimated every block by the Duong M-step); any channel
    count. FB0 (B, J, F, K) spectral patterns.
    """
    B, J, F, K = FB0.shape
    cdt = A0.dtype
    zeros = dict(device=A0.device)
    if A0.ndim == 5:
        I, R = A0.shape[-2], A0.shape[-1]
        if R != I:
            raise ValueError(
                f"online full-rank path needs square A0 (R == I), got "
                f"rank {R} with {I} channels; use rank-1 (B, J, F, I) or "
                f"full-rank (B, J, F, I, I)")
        txs = torch.zeros((B, J, F, I, I), dtype=cdt, **zeros)
    else:
        txs = torch.zeros((B, J, F, A0.shape[-1]), dtype=cdt, **zeros)
    return OnlineState(
        A=A0, FB=FB0, txs=txs,
        tss=torch.zeros((B, J, J, F), dtype=cdt, **zeros),
        t4=torch.zeros((B, J, F), dtype=FB0.dtype, **zeros),
        t7=torch.zeros((B, J, J, F), dtype=cdt, **zeros),
        fb_num=torch.zeros((B, J, F, K), dtype=FB0.dtype, **zeros),
        fb_den=torch.zeros((B, J, F, K), dtype=FB0.dtype, **zeros))


def _herm_sqrt(R):
    """Hermitian PSD square root, batched over leading dims.

    I = 2: the closed form sqrtm(R) = (R + sqrt(det R) I) / sqrt(tr R +
    2 sqrt(det R)) (Cayley-Hamilton), det R formed as a*d - |b|^2 exactly
    as the JAX package forms it (here on a ridge-loaded full-rank
    covariance); other I through eigh."""
    I = R.shape[-1]
    if I == 2:
        det = (R[..., 0, 0].real * R[..., 1, 1].real
               - (R[..., 0, 1] * R[..., 0, 1].conj()).real)
        s = torch.sqrt(torch.clamp(det, min=0.0))
        t = torch.sqrt(torch.clamp(
            R[..., 0, 0].real + R[..., 1, 1].real + 2.0 * s, min=1e-38))
        eye = torch.eye(2, dtype=R.dtype, device=R.device)
        return (R + s[..., None, None] * eye) / t[..., None, None]
    w, U = torch.linalg.eigh(R)
    w = torch.sqrt(torch.clamp(w, min=0.0))
    return torch.einsum("...ab,...b,...cb->...ac", U, w.to(U.dtype),
                        U.conj())


def _fullrank_block_step(state, Xb, TW0, sigma, lam, inner_iters, eps):
    """One full-rank streaming block: Duong covariance EM on EW stats."""
    A, FB = state.A, state.FB
    I = A.shape[-1]
    Nb = Xb.shape[2]
    R = torch.einsum("bjfar,bjfcr->bjfac", A, A.conj())   # (B, J, F, I, I)
    TWb = TW0
    for _ in range(inner_iters):
        v = torch.einsum("bjfk,bjkn->bjfn", FB, TWb)
        _, xi, _ = _fullrank_estep(Xb, R, v, sigma)
        TWb = _tw_update(FB, TWb, v, xi, eps)
    v = torch.einsum("bjfk,bjkn->bjfn", FB, TWb)
    Z_blk, xi, loglik = _fullrank_estep(Xb, R, v, sigma)

    # Duong covariance M-step on the EW accumulators
    Z = lam * state.txs + Z_blk
    cnt = lam * state.t4 + float(Nb)
    R_new = Z / cnt[..., None, None]
    tr = torch.diagonal(R_new, dim1=-2, dim2=-1).sum(-1).real  # (B, J, F)
    ridge = 1e-6 * torch.mean(tr, dim=(1, 2)) + 1e-30           # (B,)
    R_new = R_new + (ridge[:, None, None, None, None]
                     * torch.eye(I, dtype=R_new.dtype, device=R_new.device))
    A_new = _herm_sqrt(R_new).contiguous()

    # online FB update: EW-accumulated IS-NMF numerator/denominator on xi
    fb_num, fb_den = _fb_accumulate(state, v, xi, TWb, lam, eps)
    FB = torch.clamp(FB * torch.clamp(
        fb_num / torch.clamp(fb_den, min=eps), 1e-2, 1e2), min=eps)
    FB = FB / torch.clamp(torch.sum(FB, dim=2, keepdim=True), min=eps)
    new_state = OnlineState(A=A_new, FB=FB, txs=Z, tss=state.tss, t4=cnt,
                            t7=state.t7, fb_num=fb_num, fb_den=fb_den)
    return new_state, (TWb, loglik)


def _rank1_block_step(state, Xb, TW0, sigma, lam, inner_iters, eps):
    """One rank-1 streaming block (the JAX package's _make_block_step)."""
    A, FB = state.A, state.FB
    J = FB.shape[1]
    # Data-scale warm start: TW0 is a fixed random init, so the
    # multiplicative inner updates would otherwise climb the whole gap
    # between init and data scale through their per-iteration clips every
    # block. Power balance sum_i E|x_i|^2 = sum_j v_j tr(R_j) with
    # tr(R_j) = |A_j|^2 ~ 1 (columns are renormalized below) gives the
    # closed-form global gain.
    px = torch.mean(torch.sum(Xb.abs() ** 2, dim=-1), dim=(1, 2))   # (B,)
    v0 = torch.einsum("bjfk,bjkn->bjfn", FB, TW0)
    pv = torch.mean(torch.sum(v0, dim=1), dim=(1, 2))                # (B,)
    TWb = TW0 * (px / torch.clamp(pv, min=eps))[:, None, None, None]
    # the mixture plane is constant over the block: pack it once
    x4 = (cuda_estep.pack_x4(Xb) if Xb.device.type == "cuda"
          and Xb.shape[-1] == 2 else None)
    for _ in range(inner_iters):
        stats, v = _block_estep(Xb, A, FB, TWb, sigma, eps, x4)
        TWb = _tw_update(FB, TWb, v, stats.xi, eps)
    stats, v = _block_estep(Xb, A, FB, TWb, sigma, eps, x4)

    # exponential-forgetting accumulation of the spatial statistics
    txs = lam * state.txs + torch.stack(
        [stats.Txs[j][..., 0] for j in range(J)], dim=1)     # (B, J, F, I)
    tss = lam * state.tss + torch.stack(
        [torch.stack([stats.Tss[j][k][..., 0, 0] for k in range(J)], dim=1)
         for j in range(J)], dim=1)                           # (B, J, J, F)
    t4 = lam * state.t4 + torch.stack(list(stats.T4), dim=1)  # (B, J, F)
    zero = torch.zeros_like(tss[:, 0, 0])
    t7 = lam * state.t7 + torch.stack(
        [torch.stack([zero if j == k else stats.T7[j][k][..., 0, 0]
                      for k in range(J)], dim=1) for j in range(J)], dim=1)

    # rank-1 mixing update from the EW stats (Gauss-Seidel, per frequency)
    A_new = []
    for j in range(J):
        target = txs[:, j]                                    # (B, F, I)
        for k in range(J):
            if k == j:
                continue
            blk = tss[:, k, j] - t7[:, k, j]                  # (B, F)
            Ak = A_new[k] if k < j else A[:, k]               # Gauss-Seidel
            target = target - Ak * blk[..., None]
        rss = tss[:, j, j].real + t4[:, j]                    # (B, F)
        ridge = 1e-4 * torch.mean(rss, dim=-1, keepdim=True) + 1e-30
        A_new.append(target / (rss + ridge)[..., None])
    A = torch.stack(A_new, dim=1)

    # online FB update: EW-accumulated IS-NMF numerator/denominator
    fb_num, fb_den = _fb_accumulate(state, v, stats.xi, TWb, lam, eps)
    # keep the accumulator pair at O(1) magnitude: only their ratio feeds
    # the FB update, so a common per-source scale is free (without it,
    # xi/V^2 from near-dead bins compounds to float32 inf within ~20
    # blocks on a gated narrowband fixture)
    c = 1.0 / torch.clamp(torch.mean(fb_den, dim=(2, 3), keepdim=True),
                          min=eps)
    fb_num = fb_num * c
    fb_den = fb_den * c
    FB = torch.clamp(FB * torch.clamp(
        fb_num / torch.clamp(fb_den, min=eps), 1e-2, 1e2), min=eps)

    # Inter-factor renormalization (the gain degeneracy |A_j(f)|^2 v_j
    # otherwise drifts without bound across blocks): unit-norm mixing
    # columns, the gain g^2 pushed into FB, and the EW accumulators
    # rescaled by their homogeneity degrees in g_j(f) (Txs ~ g; Tss, T7 ~
    # g_j g_k; T4 ~ g^2; fb_num, fb_den ~ g^-2).
    g = torch.sqrt(torch.clamp(
        torch.sum(A.real ** 2 + A.imag ** 2, dim=-1), min=1e-20))  # (B,J,F)
    A = (A / g[..., None]).contiguous()
    txs = txs * g[..., None]
    gjk = g[:, :, None, :] * g[:, None, :, :]                # (B, J, J, F)
    tss = tss * gjk
    t7 = t7 * gjk
    t4 = t4 * g * g
    fb_num = fb_num / (g * g)[..., None]
    fb_den = fb_den / (g * g)[..., None]
    FB = FB * (g * g)[..., None]

    # normalize the FB columns (TW is per block), then a relative floor:
    # an entry that rides the 1e-2 clip every block would otherwise decay
    # to 0 and park v at the absolute xi floor
    FB = FB / torch.clamp(torch.sum(FB, dim=2, keepdim=True), min=eps)
    FB = torch.maximum(FB, 1e-8 * torch.amax(FB, dim=2, keepdim=True))

    new_state = OnlineState(A=A, FB=FB, txs=txs, tss=tss, t4=t4, t7=t7,
                            fb_num=fb_num, fb_den=fb_den)
    return new_state, (TWb, stats.loglik)


@highest_precision
def online_block(state: OnlineState, Xb: torch.Tensor, TW0: torch.Tensor,
                 sigma: torch.Tensor, forgetting: float = 0.9,
                 inner_iters: int = 4, eps: float = 1e-30):
    """Process one mixture block: (state, (TWb, loglik)).

    Xb (B, F, Nb, I) complex; TW0 (B, J, K, Nb) the per-block TW init;
    sigma (B, F) the noise PSD (held fixed: streaming has no annealing
    schedule). Returns the new state, TWb (B, J, K, Nb) and the block's
    loglik (B,), on the device, without waiting for it. The bounded-memory
    streaming entry: feed blocks from STFT.stream_blocks and carry the
    returned state. Full-rank state (A of ndim 5) takes the Duong path.
    """
    if state.A.ndim == 5:
        return _fullrank_block_step(state, Xb, TW0, sigma, forgetting,
                                    inner_iters, eps)
    return _rank1_block_step(state, Xb, TW0, sigma, forgetting, inner_iters,
                             eps)


@highest_precision
def run_gem_online(A0: torch.Tensor, FB0: torch.Tensor, TW0: torch.Tensor,
                   X: torch.Tensor, sigma: torch.Tensor, n_blocks: int,
                   forgetting: float = 0.9, inner_iters: int = 4,
                   eps: float = 1e-30):
    """Stream the mixture through `n_blocks` equal blocks (whole X given).

    A0 (B, J, F, I) complex rank-1 or (B, J, F, I, I) full-rank; FB0
    (B, J, F, K); TW0 (B, J, K, Nb) the per-block init; X (B, F, N, I) with
    N >= n_blocks * Nb; sigma (B, F). A Python loop of online_block over
    the blocks in time order. Returns (A, FB, TW_all (B, J, K,
    n_blocks * Nb), logliks (B, n_blocks)).
    """
    Nb = X.shape[2] // n_blocks
    state = online_init(A0, FB0)
    tws, lls = [], []
    for b in range(n_blocks):
        state, (TWb, ll) = online_block(
            state, X[:, :, b * Nb:(b + 1) * Nb], TW0, sigma,
            forgetting=forgetting, inner_iters=inner_iters, eps=eps)
        tws.append(TWb)
        lls.append(ll)
    return (state.A, state.FB, torch.cat(tws, dim=-1),
            torch.stack(lls, dim=-1))
