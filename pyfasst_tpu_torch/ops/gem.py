"""The GEM loop: estimate FASST parameters a posteriori.

Port of pyfasst_tpu/ops/gem.py. The JAX package compiles the whole loop
into one program; here ``run_gem`` is a Python loop of eager PyTorch steps
that never waits for the device: the log-likelihoods go into a
preallocated device tensor, the solves skip their host-side checks, and the
spatial hold is a Python bool. Callers check finiteness once per chunk
(models/fasst.py).

Annealing: the additive noise PSD Sigma_b(f) is interpolated from
sigma0(f) down to sigma1(f) over the run; it is load-bearing for the
conditioning of the per-bin 2x2 inverses.

E-step dispatch (gem_step), as the JAX gem_step takes it:
    I != 2 channels, any device     engine_general.suff_stats_general, then
                                    the unfused update_spectral. Plain
                                    PyTorch on CUDA too: the JAX package's
                                    general engine is plain XLA, with no
                                    Pallas kernel to port
    I = 2, CPU tensor               estep.compute_suff_stats
    I = 2, CUDA, kernel-eligible    cuda_estep.suff_stats_cuda: variant a
                                    (real rank-1 mixing) or the general
                                    kernel (complex mixing, rank 2, mixed
                                    ranks, 'ann_ns_inj'); fast_recip in
                                    either (variant e)
    I = 2, CUDA, anything else      NotImplementedError naming the
                                    ROADMAP entry (float64, J outside 2-4)

Spectral M-step dispatch (gem_step), as the JAX gem_step takes it:
    I = 2, CUDA tensor,             cuda_spectral.fused_spectral_update:
    fuse_spectral,                  the fb_stats and tw_stats kernels
    cuda_spectral.eligible
    anything else                   mstep.update_spectral (on the CPU
                                    fuse_spectral changes nothing, as in
                                    the JAX package, whose CPU path runs
                                    no Pallas kernel)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pyfasst_tpu_torch.models.components import FasstParams
from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral, herm
from pyfasst_tpu_torch.ops.engine_general import suff_stats_general
from pyfasst_tpu_torch.ops.estep import compute_suff_stats
from pyfasst_tpu_torch.ops.mstep import (
    _as_conv_A, renormalize, update_spatial, update_spectral,
)
from pyfasst_tpu_torch.utils.config import AnnealingMode, GEMConfig
from pyfasst_tpu_torch.utils.precision import highest_precision


def observed_covariance(X):
    """Packed empirical covariance Rxx(f,n) = x x^H, (..., F, N, 4), of a
    stereo STFT (..., F, N, 2). An inspection convenience: the E-step
    works on X directly."""
    return herm.herm_from_outer(X[..., 0], X[..., 1])


def annealing_endpoints(X, cfg: GEMConfig):
    """sigma0, sigma1 (B, F) as fractions of the mean per-frequency power of
    the mixture STFT X (B, F, N, I)."""
    return endpoints_from_power(torch.mean(X.abs() ** 2, dim=(-2, -1)), cfg)


def endpoints_from_power(Pm, cfg: GEMConfig):
    """Endpoints from a precomputed per-frequency mean power Pm (B, F).

    Silent frequency bins are floored at power_floor_frac of the clip's
    mean power so sigma stays inside float32 range.
    """
    floor = torch.clamp(cfg.power_floor_frac
                        * torch.mean(Pm, dim=-1, keepdim=True), min=cfg.eps)
    Pm = torch.maximum(Pm, floor)
    return cfg.sigma_start_frac * Pm, cfg.sigma_end_frac * Pm


def noise_psd(it: int, niter: int, sigma0, sigma1, mode: AnnealingMode):
    """Noise PSD of iteration `it`. The weight is computed in the working
    precision, as the JAX loop computes it from its int32 counter."""
    if mode == AnnealingMode.NO_ANN:
        return sigma1
    ft = np.float64 if sigma0.dtype == torch.float64 else np.float32
    w = ft(1.0) - ft(it) / ft(max(niter - 1, 1))
    return float(w) * sigma0 + float(ft(1.0) - w) * sigma1


def spatial_covs(params: FasstParams, F: int):
    """(B, J, F, 4) packed R_j for all spatial components."""
    return torch.stack([c.spatial_cov(F) for c in params.spat], dim=1)


def _estep(params, X, v, sigma, cfg: GEMConfig, x4):
    F = X.shape[1]
    ranks = tuple(c.rank for c in params.spat)
    A_conv = tuple(_as_conv_A(c, F) for c in params.spat)
    noise_inject = cfg.annealing == AnnealingMode.ANN_NS_INJ
    dev = X.device.type
    if dev == "cpu":
        Rj = spatial_covs(params, F)
        return compute_suff_stats(X, v, Rj, sigma, ranks, eps=cfg.eps,
                                  noise_inject=noise_inject, A_conv=A_conv)
    if dev != "cuda":
        raise NotImplementedError(f"no GEM path for device {X.device}")
    # instantaneous models have real mixing: the kernels then drop the
    # arithmetic on its identically-zero imaginary parts
    real_cov = all(not c.A.is_complex() for c in params.spat)
    why = cuda_estep.kernel_eligible(ranks, real_cov, noise_inject, v.dtype,
                                     cfg.fast_recip, X.shape[-1])
    if why:
        raise NotImplementedError(
            f"no CUDA E-step for this model: {why} is not ported yet "
            "(see ROADMAP.md)")
    return cuda_estep.suff_stats_cuda(X, v, None, sigma, ranks, A_conv,
                                      eps=cfg.eps, noise_inject=noise_inject,
                                      x4=x4, real_cov=real_cov,
                                      fast_recip=cfg.fast_recip)


def gem_step(params: FasstParams, X, sigma, cfg: GEMConfig,
             spatial_enabled: bool = True, x4=None
             ) -> Tuple[FasstParams, torch.Tensor]:
    """One GEM iteration; returns updated params and the (B,) step
    log-likelihood.

    X is the complex mixture STFT (B, F, N, I). x4 optionally carries
    cuda_estep.pack_x4(X), hoisted out of the loop by run_gem.
    """
    v = params.all_source_powers()                    # (B, J, F, N)
    if X.shape[-1] != 2:
        # the general-I engine, on either device, and the unfused spectral
        # M-step (pyfasst_tpu/ops/gem.py:92-103)
        F = X.shape[1]
        stats = suff_stats_general(
            X, v, tuple(_as_conv_A(c, F) for c in params.spat), sigma,
            tuple(c.rank for c in params.spat), eps=cfg.eps,
            noise_inject=cfg.annealing == AnnealingMode.ANN_NS_INJ)
        params = update_spatial(params, stats, sigma,
                                enabled=spatial_enabled)
        params = update_spectral(params, stats, eps=cfg.eps, v=v)
        if cfg.renormalize:
            params = renormalize(params)
        return params, stats.loglik
    stats = _estep(params, X, v, sigma, cfg, x4)
    params = update_spatial(params, stats, sigma, enabled=spatial_enabled)
    if (cfg.fuse_spectral and X.device.type == "cuda"
            and cuda_spectral.eligible(params)):
        params = cuda_spectral.fused_spectral_update(params, stats,
                                                     eps=cfg.eps)
    else:
        params = update_spectral(params, stats, eps=cfg.eps, v=v)
    if cfg.renormalize:
        params = renormalize(params)
    return params, stats.loglik


@highest_precision
def run_gem(params: FasstParams, X, cfg: GEMConfig, start_iter: int = 0,
            sigma_endpoints=None, end_iter: Optional[int] = None,
            logliks: Optional[torch.Tensor] = None
            ) -> Tuple[FasstParams, torch.Tensor]:
    """Run GEM iterations [start_iter, end_iter or cfg.niter).

    X is the complex mixture STFT (B, F, N, I). Returns (params, logliks)
    with logliks a (B, cfg.niter) float32 tensor on X's device, entries
    outside the executed range left as they were (zero in a new tensor;
    pass `logliks` to fill one across chunks). The annealing schedule is a
    pure function of the iteration index against the FULL cfg.niter, so a
    chunked or resumed trajectory is exactly the uninterrupted one.
    sigma_endpoints, if given, is a (sigma0, sigma1) pair of (B, F) tensors
    overriding the endpoints derived from X.

    Matrix products run in full float32 (no TF32).
    """
    sigma0, sigma1 = (annealing_endpoints(X, cfg) if sigma_endpoints is None
                      else sigma_endpoints)
    if logliks is None:
        logliks = torch.zeros((X.shape[0], cfg.niter), dtype=torch.float32,
                              device=X.device)
    hold = int(cfg.spatial_hold_frac * cfg.niter)
    # pack the constant mixture plane once, not once per iteration
    x4 = (cuda_estep.pack_x4(X) if X.device.type == "cuda"
          and X.shape[-1] == 2 else None)
    stop = cfg.niter if end_iter is None else end_iter
    for it in range(start_iter, stop):
        sigma = noise_psd(it, cfg.niter, sigma0, sigma1, cfg.annealing)
        params, ll = gem_step(params, X, sigma, cfg,
                              spatial_enabled=it >= hold, x4=x4)
        logliks[:, it] = ll.to(torch.float32)
    return params, logliks
