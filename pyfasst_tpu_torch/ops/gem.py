"""The GEM loop: estimate FASST parameters a posteriori.

Port of pyfasst_tpu/ops/gem.py. The JAX package compiles the whole loop
into one program; here ``run_gem`` loops over PyTorch steps that never
wait for the device: the log-likelihoods go into a preallocated device
tensor, the solves skip their host-side checks, and the spatial hold is a
Python bool. Callers check finiteness once per chunk (models/fasst.py).

On the card (graph_rule) the host enqueues two steps of each side of the
spatial hold stage by stage: it runs the first eagerly, captures the next
as a CUDA graph and replays that graph for each further iteration, one
launch an iteration in place of the step's ~120-180. The graph reads and
writes the parameters in place in the eager step's outputs, picks the
noise PSD from a table of annealing weights (annealing_weights, bit for
bit noise_psd's) and writes the log-likelihood by a counter on the device.
Everything else (the CPU, the general-I engine, a shard, a GMM/HMM or
source-filter model, a single iteration) runs the eager loop,
``_eager_loop``.

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
                                    ranks, 'ann_ns_inj'; any J, past 16
                                    with J at run time); fast_recip in
                                    either (variant e)
    I = 2, CUDA, anything else      NotImplementedError naming why
                                    (float64, ranks past 2, more than
                                    4096 sources)

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

from pyfasst_tpu_torch.models.components import NMF, FasstParams
from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral, herm
from pyfasst_tpu_torch.ops.engine_general import suff_stats_general
from pyfasst_tpu_torch.ops.estep import compute_suff_stats
from pyfasst_tpu_torch.ops.mstep import (
    _as_conv_A, renormalize, update_spatial, update_spectral,
)
from pyfasst_tpu_torch.ops.collectives import active_axis, reduce_stats
from pyfasst_tpu_torch.utils import logging as tlog
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


def estep_stereo(X, v, A_conv, ranks, sigma, real_cov: bool,
                 eps: float = 1e-30, noise_inject: bool = False,
                 fast_recip: bool = False, x4=None):
    """The I = 2 E-step on X's device, dispatched as the module docstring
    says: compute_suff_stats for a CPU tensor, the kernels through
    cuda_estep.suff_stats_cuda for a CUDA tensor, NotImplementedError for
    an E-step no kernel computes. Shared by gem_step and the streaming
    block step (ops/online.py).

    A_conv: per source complex (B, F, 2, R_j) mixing; real_cov asserts its
    imaginary parts are zero (the instantaneous models), and the kernels
    then drop the arithmetic on them. x4: cuda_estep.pack_x4(X), hoisted
    out of the caller's loop.
    """
    dev = X.device.type
    if dev == "cpu":
        Rj = torch.stack([herm.herm_from_mixing(A) for A in A_conv], dim=1)
        return compute_suff_stats(X, v, Rj, sigma, ranks, eps=eps,
                                  noise_inject=noise_inject, A_conv=A_conv)
    if dev != "cuda":
        raise NotImplementedError(f"no E-step for device {X.device}")
    why = cuda_estep.kernel_eligible(ranks, real_cov, noise_inject, v.dtype,
                                     fast_recip, X.shape[-1])
    if why:
        raise NotImplementedError(
            f"no CUDA E-step for this model: {why} is not ported yet "
            "(see ROADMAP.md)")
    return cuda_estep.suff_stats_cuda(X, v, None, sigma, ranks, A_conv,
                                      eps=eps, noise_inject=noise_inject,
                                      x4=x4, real_cov=real_cov,
                                      fast_recip=fast_recip)


def _estep(params, X, v, sigma, cfg: GEMConfig, x4):
    F = X.shape[1]
    return estep_stereo(
        X, v, tuple(_as_conv_A(c, F) for c in params.spat),
        tuple(c.rank for c in params.spat), sigma,
        real_cov=all(not c.A.is_complex() for c in params.spat),
        eps=cfg.eps,
        noise_inject=cfg.annealing == AnnealingMode.ANN_NS_INJ,
        fast_recip=cfg.fast_recip, x4=x4)


def gem_step(params: FasstParams, X, sigma, cfg: GEMConfig,
             spatial_enabled: bool = True, x4=None, traced: bool = False
             ) -> Tuple[FasstParams, torch.Tensor]:
    """One GEM iteration; returns updated params and the (B,) step
    log-likelihood.

    X is the complex mixture STFT (B, F, N, I). x4 optionally carries
    cuda_estep.pack_x4(X), hoisted out of the loop by run_gem. Under a
    shard of parallel/sharding.py X is this rank's slice, and the E-step's
    sums over the sharded axis are finished by reduce_stats. traced (the
    caller has read utils/logging.recording() as true) records the spans
    gem.e_step, gem.m_spatial and gem.m_spectral.
    """
    if traced:
        stage = tlog.begin("gem.e_step")
    v = params.all_source_powers()                    # (B, J, F, N)
    if X.shape[-1] != 2:
        # the general-I engine, on either device, and the unfused spectral
        # M-step (pyfasst_tpu/ops/gem.py:92-103)
        F = X.shape[1]
        stats = reduce_stats(suff_stats_general(
            X, v, tuple(_as_conv_A(c, F) for c in params.spat), sigma,
            tuple(c.rank for c in params.spat), eps=cfg.eps,
            noise_inject=cfg.annealing == AnnealingMode.ANN_NS_INJ))
    else:
        stats = reduce_stats(_estep(params, X, v, sigma, cfg, x4))
    if traced:
        tlog.end(stage)
        stage = tlog.begin("gem.m_spatial")
    params = update_spatial(params, stats, sigma, enabled=spatial_enabled)
    if traced:
        tlog.end(stage)
        stage = tlog.begin("gem.m_spectral")
    if (X.shape[-1] == 2 and cfg.fuse_spectral and X.device.type == "cuda"
            and cuda_spectral.eligible(params)):
        params = cuda_spectral.fused_spectral_update(params, stats,
                                                     eps=cfg.eps)
    else:
        params = update_spectral(params, stats, eps=cfg.eps, v=v)
    if cfg.renormalize:
        params = renormalize(params)
    if traced:
        tlog.end(stage)
    return params, stats.loglik


@tlog.span("gem.run")
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

    Where graph_rule finds nothing against it, each segment of two or more
    iterations on one side of the spatial hold runs its first iteration
    eagerly and the others as replays of one iteration captured as a CUDA
    graph (the same kernels, in the same order, on the same bits);
    everything else runs the eager loop.

    Matrix products run in full float32 (no TF32). Under a torch profiler
    the call is the span gem.run; each eager iteration's stages, and each
    capture (gem.capture, the stages inside it) and replay (gem.replay),
    are spans inside it (utils/logging.py).
    """
    if sigma_endpoints is None and active_axis() is not None:
        raise ValueError("a sharded run_gem needs the endpoints of the "
                         "whole plane (parallel/sharding.batched_run_gem)")
    ends = (annealing_endpoints(X, cfg) if sigma_endpoints is None
            else tuple(sigma_endpoints))
    if logliks is None:
        logliks = torch.zeros((X.shape[0], cfg.niter), dtype=torch.float32,
                              device=X.device)
    # pack the constant mixture plane once, not once per iteration
    x4 = (cuda_estep.pack_x4(X) if X.device.type == "cuda"
          and X.shape[-1] == 2 else None)
    stop = cfg.niter if end_iter is None else end_iter
    traced = tlog.recording()
    if graph_rule(params, X, cfg):
        params = _eager_loop(params, X, cfg, start_iter, stop, ends,
                             logliks, x4, traced)
        return params, logliks
    weights = None
    hold = int(cfg.spatial_hold_frac * cfg.niter)
    for a, b in _segments(start_iter, stop, hold):
        if b - a < 2:
            params = _eager_loop(params, X, cfg, a, b, ends, logliks, x4,
                                 traced)
            continue
        if weights is None:
            weights = _device_weights(cfg, ends[0].dtype, X.device)
        params = _graphed(params, X, cfg, a, b, a >= hold, ends, weights,
                          logliks, x4, traced)
    return params, logliks


GRAPH_STEPS = {"captures": 0, "replayed": 0, "eager": 0}
"""GEM iterations of this process by how run_gem ran them: "eager" (each
stage enqueued by the host) and "replayed" (one launch of a captured CUDA
graph), and the graphs "captured". Callers reset it before the run they
want to count, as they reset cuda_estep.LAUNCHES."""


def graph_rule(params: FasstParams, X, cfg: GEMConfig) -> str:
    """'' when run_gem replays its iterations as CUDA graphs, else why it
    runs them eagerly. A function of the call's inputs alone: the graph
    takes the I = 2 engine's kernel E-step on a CUDA tensor, outside a
    shard, with every spectral component a plain NMF chain."""
    if X.shape[-1] != 2:
        return (f"I = {X.shape[-1]} channels (the general-I engine is not "
                "captured)")
    if active_axis() is not None:
        return "a sharded run (its sums finish in collectives)"
    if any(c.constraint != NMF or c.FB2 is not None for c in params.spec):
        return ("a GMM/HMM state or source-filter component (their "
                "updates are not captured)")
    why = cuda_estep.kernel_eligible(
        tuple(c.rank for c in params.spat),
        all(not c.A.is_complex() for c in params.spat),
        cfg.annealing == AnnealingMode.ANN_NS_INJ,
        params.spec[0].FB.dtype, cfg.fast_recip, 2)
    if why:
        return why
    if X.device.type != "cuda":
        return f"a {X.device.type} tensor (graphs are CUDA's)"
    return ""


def annealing_weights(niter: int, dtype, mode: AnnealingMode) -> np.ndarray:
    """(niter, 2) weights of sigma0 and sigma1 at each iteration, in
    `dtype`'s precision, by noise_psd's own NumPy arithmetic: the noise PSD
    of iteration it is w[it, 0] * sigma0 + w[it, 1] * sigma1
    (noise_psd_from), bit for bit noise_psd's."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    if mode == AnnealingMode.NO_ANN:
        w = np.zeros(niter, dtype=ft)
    else:
        w = ft(1.0) - np.arange(niter, dtype=ft) / ft(max(niter - 1, 1))
    return np.stack([w, ft(1.0) - w], axis=1)


def noise_psd_from(w, sigma0, sigma1):
    """The noise PSD from a row w (..., 2) of annealing_weights, as a
    tensor of sigma0's dtype: the products and the sum noise_psd forms."""
    return w[..., 0:1] * sigma0 + w[..., 1:2] * sigma1


def _segments(start: int, stop: int, hold: int):
    """[a, b) runs of iterations on one side of the spatial hold."""
    cuts = sorted({start, stop, min(max(hold, start), stop)})
    return list(zip(cuts, cuts[1:]))


def _eager_loop(params, X, cfg, start, stop, ends, logliks, x4, traced):
    """Iterations [start, stop) enqueued one stage at a time by the host."""
    hold = int(cfg.spatial_hold_frac * cfg.niter)
    for it in range(start, stop):
        sigma = noise_psd(it, cfg.niter, *ends, cfg.annealing)
        params, ll = gem_step(params, X, sigma, cfg,
                              spatial_enabled=it >= hold, x4=x4,
                              traced=traced)
        logliks[:, it] = ll.to(torch.float32)
    GRAPH_STEPS["eager"] += max(stop - start, 0)
    return params


def _leaves(params: FasstParams) -> list:
    """The tensors of params, in a fixed order."""
    out = [c.A for c in params.spat]
    for c in params.spec:
        out += [t for t in (c.FB, c.TW, c.FW, c.TB, c.trans, c.FB2, c.TW2)
                if t is not None]
    return out


_CAPTURE = {}
"""Per CUDA device: [the side stream run_gem captures on, the private
memory pool every capture shares, the newest graph]. A capture's
intermediates free again in the pool for the next capture. The newest
graph is kept so that the pool is never left without a graph: PyTorch's
allocators cannot capture into a pool again once its last graph is gone
(an internal assert), and a new pool a call would leave each old one's
memory reserved until an allocation fails."""


def _capture_resources(dev) -> list:
    if dev not in _CAPTURE:
        _CAPTURE[dev] = [torch.cuda.Stream(dev),
                         torch.cuda.graph_pool_handle(), None]
    return _CAPTURE[dev]


def _device_weights(cfg, dtype, dev):
    """annealing_weights on the card, copied without waiting for it."""
    w = torch.from_numpy(annealing_weights(cfg.niter, dtype, cfg.annealing))
    return w.pin_memory().to(dev, non_blocking=True)


def _graphed(params, X, cfg, a, b, spatial, ends, weights, logliks, x4,
             traced):
    """Iterations [a, b) of one side of the hold: the first one eagerly, the
    others as replays of one iteration captured on the side stream from
    the eager step's outputs. Those outputs, laid out as the step lays
    them out, are the buffers each replay reads and writes back in place,
    so a replay reads the layout the eager loop would; the eager step also
    loads the kernels' modules before the capture. A device counter picks
    an iteration's noise PSD and log-likelihood column. cuBLAS keeps a
    workspace for each stream: the workspaces are dropped around the
    capture, as torch's inductor does around its graphs, so the capture
    takes the side stream's from the graph's pool, where it stays for the
    graph (only a later capture into the pool, replayed after this graph,
    can reuse it), and no second workspace stays allocated."""
    dev = X.device
    with torch.cuda.device(dev):
        res = _capture_resources(dev)
        side, cur = res[0], torch.cuda.current_stream(dev)
        state = _eager_loop(params, X, cfg, a, a + 1, ends, logliks, x4,
                            traced)
        counter = torch.full((1,), a + 1, dtype=torch.long, device=dev)
        graph = torch.cuda.CUDAGraph()
        if traced:
            token = tlog.begin("gem.capture")
        torch._C._cuda_clearCublasWorkspaces()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=res[1],
                                capture_error_mode="thread_local")
            try:
                sigma = noise_psd_from(weights.index_select(0, counter),
                                       *ends)
                new, ll = gem_step(state, X, sigma, cfg,
                                   spatial_enabled=spatial, x4=x4,
                                   traced=traced)
                logliks.index_copy_(1, counter, ll.to(torch.float32)[:, None])
                for old, out in zip(_leaves(state), _leaves(new)):
                    if out is not old:
                        old.copy_(out)
                counter.add_(1)
            finally:
                graph.capture_end()
        torch._C._cuda_clearCublasWorkspaces()
        cur.wait_stream(side)
        if traced:
            tlog.end(token)
        res[2] = graph
        GRAPH_STEPS["captures"] += 1
        for _ in range(a + 1, b):
            if traced:
                token = tlog.begin("gem.replay")
            graph.replay()
            if traced:
                tlog.end(token)
    GRAPH_STEPS["replayed"] += b - a - 1
    return state
