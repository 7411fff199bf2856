"""GEM M-step: spatial mixing updates and IS-NMF spectral updates.

Port of pyfasst_tpu/ops/mstep.py, with a leading clip axis B:

  - spatial: Gauss-Seidel block-coordinate ascent, one source at a time,

        A_j <- (R^_xs,j - sum_{j'!=j} A_j' R^_ss[j',j]) @ R^_ss[j,j]^-1

    'inst' components pool the solve over frequency with 1/sigma(f)
    weights; 'conv' components (full-rank = conv with R == I) solve per
    frequency with a proximal ridge and a per-frequency norm floor.

  - spectral free factors: IS-NMF multiplicative updates against the
    posterior PSD xi_j, factors updated sequentially with V_j refreshed
    after each update.

  - source-filter (SIMM) components, v = chain1 * (FB2 @ TW2): each
    chain's multiplicative updates weighted by the other chain's envelope.

  - GMM/HMM components: free FB/FW learn by their NMF rules, then the
    discrete-state E-step (ops/hmm.py) replaces the TW update.

The solves use torch.linalg.solve_ex(check_errors=False): it does not
check its result on the host, so the GEM loop never waits for the device.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from pyfasst_tpu_torch.models.components import (
    INST, NMF, FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_tpu_torch.ops import herm, hmm
from pyfasst_tpu_torch.ops.estep import SuffStats
from pyfasst_tpu_torch.ops.collectives import (
    contract, mean_over, sum_over,
)


def _as_conv_A(comp: SpatialComp, F: int) -> torch.Tensor:
    """A as complex (B, F, I, R) regardless of mixing type."""
    return comp.conv_mixing(F)


def _solve(A, B):
    """X with A X = B, without a host-side check of the result."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _eye(R: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(R, dtype=like.dtype, device=like.device)


def update_spatial(params: FasstParams, stats: SuffStats, sigma,
                   eps: float = 1e-12, enabled: bool = True) -> FasstParams:
    """One spatial M-step: Gauss-Seidel sweep over free spatial components.

        R^_ss[j,j] = Tss_jj + T4_j,   R^_ss[k,j] = Tss_kj - T7_kj,
        A_j <- (Txs_j - sum_{k != j} A_k R^_ss[k,j]) @ R^_ss[j,j]^-1

    sigma (B, F) is the current annealed noise PSD, used as the exact
    1/sigma frequency weighting for pooled 'inst' solves (weights normalized
    to unit mean per clip). `enabled` is a Python bool: when False the old
    mixing is kept (the spatial hold-off phase).
    """
    if not enabled:
        return params
    F = stats.Txs[0].shape[1]
    J = len(params.spat)
    A_all = [_as_conv_A(c, F) for c in params.spat]   # complex (B, F, I, Rj)
    new_spat: List[SpatialComp] = list(params.spat)
    w = 1.0 / torch.clamp(sigma, min=1e-30)
    w = w / mean_over(w, -1, "F", keepdim=True)        # (B, F)

    for j, comp in enumerate(params.spat):
        if not comp.free:
            continue
        R = comp.rank
        target = stats.Txs[j]                          # (B, F, 2, R)
        for k in range(J):
            if k == j:
                continue
            block = stats.Tss[k][j] - stats.T7[k][j]   # R^_ss[k, j]
            target = target - A_all[k] @ block
        if R >= 2:
            T4j = stats.T4[j]
            post = T4j if T4j.ndim == 4 else herm.herm_to_complex(T4j)
        else:
            post = stats.T4[j][..., None, None].to(target.dtype)
        Rss = stats.Tss[j][j] + post                    # (B, F, R, R)
        if comp.mix_type == INST:
            wf = w[:, :, None, None]
            target_p = sum_over(wf * target, 1, "F").real    # (B, I, R)
            Rss_p = sum_over(wf * Rss, 1, "F").real          # (B, R, R)
            tr = torch.diagonal(Rss_p, dim1=-2, dim2=-1).sum(-1)
            Rss_p = Rss_p + eps * tr[:, None, None] * _eye(R, Rss_p)
            A_new = _solve(Rss_p.mT, target_p.mT).mT
        else:  # conv / full-rank: per-frequency solve
            # Proximal ridge toward the current mixing: starved frequencies
            # otherwise get A = tiny/tiny garbage that compounds into
            # unbounded growth.
            A = A_all[j]
            tr = torch.diagonal(Rss, dim1=-2, dim2=-1).sum(-1).real  # (B, F)
            ridge = (eps * tr + 1e-4 * mean_over(tr, -1, "F", keepdim=True)
                     + 1e-30).to(tr.dtype)
            target = target + ridge[..., None, None] * A
            Rss = Rss + ridge[..., None, None] * _eye(R, A)
            A_new = _solve(Rss.mT, target.mT).mT
            # Per-frequency norm floor against the renormalization ratchet:
            # starved bins sit at the ridge-frozen A_old, which the global
            # renormalization divides down every iteration; flooring each
            # bin's norm at 1e-3 of the source's rms ties them to the
            # source's global scale.
            r2 = torch.sum(A_new.abs() ** 2, dim=(2, 3))       # (B, F)
            floor2 = 1e-6 * mean_over(r2, -1, "F", keepdim=True)
            boost = torch.sqrt(floor2 / torch.clamp(r2, min=1e-38))
            boost = torch.clamp(boost, min=1.0).to(A_new.real.dtype)
            A_new = A_new * boost[..., None, None]
        # contiguous, as a loaded checkpoint's A is: a resumed run then
        # repeats the uninterrupted one's products bit for bit
        A_new = A_new.to(comp.A.dtype).contiguous()
        new_spat[j] = comp.replace(A=A_new)
        A_all[j] = _as_conv_A(new_spat[j], F)         # Gauss-Seidel refresh
    return params.replace(spat=tuple(new_spat))


# -- spectral -----------------------------------------------------------------

# Float32 guards shared by every multiplicative update: ratio clamp against
# dead-component 0/0 swings, eps factor floor.
UPD_MIN, UPD_MAX = 1e-5, 1e5


def _mul_upd(factor, num_term, den_term, eps):
    upd = torch.clamp(num_term / torch.clamp(den_term, min=eps),
                      UPD_MIN, UPD_MAX)
    return torch.clamp(factor * upd, min=eps)


def _nmf_factor_updates(comp: SpectralComp, P, V, eps: float
                        ) -> Tuple[SpectralComp, torch.Tensor]:
    """Sequential multiplicative updates of this component's free factors.

    P (B, F, N) is the fixed posterior PSD xi_j; V the current total source
    model PSD. Returns the updated component and the refreshed V.

    Float32 safeguards:
      - V is floored RELATIVE to the observed scale (per clip): V**-2 at an
        absolute eps floor overflows float32 when factor products underflow.
      - the multiplicative ratio is clamped to [UPD_MIN, UPD_MAX].
    """
    def mul_upd(factor, num_term, den_term):
        return _mul_upd(factor, num_term, den_term, eps)

    vk = comp.power()
    v_floor = 1e-12 * mean_over(P, (-2, -1), "FN", keepdim=True) + eps
    for idx in range(4):
        if not comp.free[idx]:
            continue
        Vc = torch.maximum(V, v_floor)
        num = P / (Vc * Vc)              # (B, F, N)
        den = 1.0 / Vc
        W = comp.freq_pattern()          # (B, F, K)
        H = comp.time_activation()       # (B, K, N)
        # each statistic is finished over the axes it contracts
        if idx == 0:                     # FB (B, F, L)
            rest = H if comp.FW is None else comp.FW @ H
            comp = comp.replace(FB=mul_upd(
                comp.FB, contract(num @ rest.mT, "N"),
                contract(den @ rest.mT, "N")))
        elif idx == 1:                   # FW (B, L, K)
            lhs_n = comp.FB.mT @ num
            lhs_d = comp.FB.mT @ den
            comp = comp.replace(FW=mul_upd(
                comp.FW, contract(lhs_n @ H.mT, "FN"),
                contract(lhs_d @ H.mT, "FN")))
        elif idx == 2:                   # TW (B, K, M)
            lhs_n = W.mT @ num
            lhs_d = W.mT @ den
            axes = "F"
            if comp.TB is not None:
                lhs_n, lhs_d = lhs_n @ comp.TB.mT, lhs_d @ comp.TB.mT
                axes = "FN"
            comp = comp.replace(TW=mul_upd(comp.TW, contract(lhs_n, axes),
                                           contract(lhs_d, axes)))
        else:                            # TB (B, M, N)
            G = W @ comp.TW
            comp = comp.replace(TB=mul_upd(comp.TB,
                                           contract(G.mT @ num, "F"),
                                           contract(G.mT @ den, "F")))
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    return comp, V


def _simm_factor_updates(comp: SpectralComp, P, V, eps: float
                         ) -> Tuple[SpectralComp, torch.Tensor]:
    """Multiplicative source-filter component: v = chain1 * (FB2 @ TW2).

    IS-NMF multiplicative updates where each chain's gradient is weighted by
    the OTHER chain's envelope (cf. Durrieu's SIMM; models/lead.py uses the
    same rules standalone). Each statistic is finished over the axes it
    contracts, as in _nmf_factor_updates.
    """
    def mul_upd(factor, num_term, den_term):
        return _mul_upd(factor, num_term, den_term, eps)

    vk = comp.power()
    v_floor = 1e-12 * mean_over(P, (-2, -1), "FN", keepdim=True) + eps
    # chain1 factors (standard rules on the envelope-weighted residual)
    for idx in range(4):
        if not comp.free[idx]:
            continue
        Vc = torch.maximum(V, v_floor)
        E2 = comp.FB2 @ comp.TW2
        num = (P / (Vc * Vc)) * E2
        den = (1.0 / Vc) * E2
        W = comp.freq_pattern()
        H = comp.time_activation()
        if idx == 0:
            rest = H if comp.FW is None else comp.FW @ H
            comp = comp.replace(FB=mul_upd(
                comp.FB, contract(num @ rest.mT, "N"),
                contract(den @ rest.mT, "N")))
        elif idx == 1:
            comp = comp.replace(FW=mul_upd(
                comp.FW, contract((comp.FB.mT @ num) @ H.mT, "FN"),
                contract((comp.FB.mT @ den) @ H.mT, "FN")))
        elif idx == 2:
            lhs_n, lhs_d = W.mT @ num, W.mT @ den
            axes = "F"
            if comp.TB is not None:
                lhs_n, lhs_d = lhs_n @ comp.TB.mT, lhs_d @ comp.TB.mT
                axes = "FN"
            comp = comp.replace(TW=mul_upd(comp.TW, contract(lhs_n, axes),
                                           contract(lhs_d, axes)))
        else:
            G = W @ comp.TW
            comp = comp.replace(TB=mul_upd(comp.TB,
                                           contract(G.mT @ num, "F"),
                                           contract(G.mT @ den, "F")))
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    # chain2 factors (weighted by chain1's product)
    for idx2 in range(2):
        if not comp.free2[idx2]:
            continue
        Vc = torch.maximum(V, v_floor)
        C1 = comp.freq_pattern() @ comp.time_activation()
        num = (P / (Vc * Vc)) * C1
        den = (1.0 / Vc) * C1
        if idx2 == 0:                    # FB2 (B, F, G)
            comp = comp.replace(FB2=mul_upd(
                comp.FB2, contract(num @ comp.TW2.mT, "N"),
                contract(den @ comp.TW2.mT, "N")))
        else:                            # TW2 (B, G, N)
            comp = comp.replace(TW2=mul_upd(
                comp.TW2, contract(comp.FB2.mT @ num, "F"),
                contract(comp.FB2.mT @ den, "F")))
        vk_new = comp.power()
        V = V - vk + vk_new
        vk = vk_new
    return comp, V


def update_spectral(params: FasstParams, stats: SuffStats,
                    eps: float = 1e-30, v=None) -> FasstParams:
    """One spectral M-step: every free factor of every component.

    v (B, J, F, N), if given, is the source-power stack already computed by
    the E-step, reused as the initial model PSD per source.
    """
    spec = list(params.spec)
    for j in range(params.n_spat):
        idxs = [i for i, k in enumerate(spec) if k.spat_ind == j]
        if not idxs:
            continue
        P = stats.xi[:, j]
        if v is not None:
            V = v[:, j]
        else:
            V = spec[idxs[0]].power()
            for i in idxs[1:]:
                V = V + spec[i].power()
        for i in idxs:
            comp = spec[i]
            if comp.FB2 is not None:   # multiplicative source-filter (SIMM)
                comp, V = _simm_factor_updates(comp, P, V, eps)
            elif comp.constraint == NMF:
                comp, V = _nmf_factor_updates(comp, P, V, eps)
            else:
                # GMM / HMM: the discrete-state E-step replaces the TW
                # update, but free FB/FW (the state spectral templates)
                # still learn by their NMF rules
                if comp.free[0] or comp.free[1]:
                    nmf_free = (comp.free[0], comp.free[1], False, False)
                    comp, V = _nmf_factor_updates(
                        comp.replace(free=nmf_free), P, V, eps)
                    comp = comp.replace(free=spec[i].free)
                comp, V = hmm.state_factor_update(comp, P, V, eps)
            spec[i] = comp
    return params.replace(spec=tuple(spec))


# -- renormalization ------------------------------------------------------------

def renormalize(params: FasstParams) -> FasstParams:
    """Rebalance scales to stop drift over hundreds of iterations.

    (a) spatial: scale each free A_j to unit mean spatial power and push the
        power into the first free factor of each attached spectral component;
    (b) spectral chains: L1-normalize each free factor whose right neighbour
        in the FB->FW->TW->TB chain is also free, pushing the scale right.
    Every scale is per clip.
    """
    spat = list(params.spat)
    spec = list(params.spec)

    for j, comp in enumerate(spat):
        if not comp.free:
            continue
        if comp.mix_type == INST:
            norm = torch.sum(comp.A ** 2, dim=(1, 2)) / comp.A.shape[1]
        else:
            norm = mean_over(torch.sum(comp.A.abs() ** 2, dim=(2, 3)),
                             1, "F") / comp.A.shape[2]
        norm = torch.clamp(norm, min=1e-30)                   # (B,)
        scale = torch.sqrt(norm).to(comp.A.dtype)
        spat[j] = comp.replace(
            A=comp.A / scale.reshape((-1,) + (1,) * (comp.A.ndim - 1)))
        for i, k in enumerate(spec):
            if k.spat_ind != j:
                continue
            spec[i] = _scale_first_free(k, norm)

    for i, k in enumerate(spec):
        spec[i] = _chain_normalize(k)
    return params.replace(spat=tuple(spat), spec=tuple(spec))


def _scale_first_free(comp: SpectralComp, s) -> SpectralComp:
    """Multiply the first free factor by the per-clip scale s (B,); with no
    free factor in the first chain, a source-filter component's first free
    factor of the second (FB2, TW2)."""
    names = ("FB", "FW", "TW", "TB")
    for idx, name in enumerate(names):
        factor = getattr(comp, name)
        if comp.free[idx] and factor is not None:
            return comp.replace(**{name: factor * s[:, None, None]})
    if comp.FB2 is not None:
        for idx2, name in enumerate(("FB2", "TW2")):
            if comp.free2[idx2]:
                return comp.replace(
                    **{name: getattr(comp, name) * s[:, None, None]})
    return comp


def _chain_normalize(comp: SpectralComp, eps: float = 1e-30) -> SpectralComp:
    """Push column scales rightward between adjacent free factors."""
    chain = [(i, n) for i, n in enumerate(("FB", "FW", "TW", "TB"))
             if getattr(comp, n) is not None]
    upd = {}
    mats = {n: getattr(comp, n) for _, n in chain}
    for (ia, na), (ib, nb) in zip(chain[:-1], chain[1:]):
        if not (comp.free[ia] and comp.free[ib]):
            continue
        # FB's rows are frequencies; FW's and TW's rows are not sharded
        s = torch.sum(mats[na], dim=-2)                        # (B, cols)
        if na == "FB":
            s = contract(s, "F")
        s = torch.clamp(s, min=eps)
        mats[na] = mats[na] / s[:, None, :]
        mats[nb] = mats[nb] * s[:, :, None]
        upd[na], upd[nb] = mats[na], mats[nb]
    return comp.replace(**upd) if upd else comp
