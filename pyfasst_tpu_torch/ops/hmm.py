"""GMM / HMM spectral-state E-step (discrete states).

Port of pyfasst_tpu/ops/hmm.py, with a leading clip axis B. Each frame
activates ONE spectral state q with a free gain; state posteriors (GMM: a
softmax of per-frame log-likelihoods; HMM: forward-backward over the
transition matrix) replace the NMF TW update.

The JAX recursions are lax.scans over frames. Here each is a Python loop
over frames whose step is one batched operation over clips and states (a
logsumexp over a (B, Q, Q) tensor, or a max with its argmax), written into
a preallocated (B, N, Q) tensor. On the card every step is a handful of
small kernels (a logsumexp alone is several), so an HMM component costs
on the order of ten launches per frame and pass: the first path whose
launch count grows with N. The
Viterbi backtrack stays on the device, one gather per frame. Transitions
and GMM priors are never re-estimated, as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from pyfasst_tpu_torch.models.components import GMM, HMM, SpectralComp


def _state_gains_and_loglik(P: torch.Tensor, W: torch.Tensor, eps: float):
    """Per-(state, frame) IS-optimal gains and log-likelihoods.

    P (B, F, N) observed PSD, W (B, F, Q) state patterns. The IS-optimal
    gain is g(q,n) = mean_f P(f,n)/w_q(f), and the (negative) divergence at
    the optimum gives the state log-likelihood
        L(q,n) = -sum_f [ log(g w_q) + 1 ]  (- sum_f log P, const in q)
    Returns g, L, each (B, Q, N).
    """
    F = P.shape[-2]
    Winv = 1.0 / torch.clamp(W, min=eps)                      # (B, F, Q)
    g = torch.clamp((Winv.mT @ P) / F, min=eps)               # (B, Q, N)
    logw = torch.sum(torch.log(torch.clamp(W, min=eps)), dim=-2)  # (B, Q)
    L = -(F * torch.log(g) + logw[..., None] + F)             # (B, Q, N)
    return g, L


def _gmm_posteriors(L: torch.Tensor, log_prior: torch.Tensor):
    """Softmax over states of L (B, Q, N) + log_prior (B, Q)."""
    return torch.softmax(L + log_prior[..., None], dim=-2)


def _log_pi(L: torch.Tensor) -> torch.Tensor:
    """The uniform initial state distribution, in L's dtype."""
    Q = L.shape[-2]
    return torch.full((Q,), -math.log(Q), dtype=L.dtype, device=L.device)


def _hmm_posteriors(L: torch.Tensor, log_trans: torch.Tensor):
    """Forward-backward in log space. L (B, Q, N) per-(state, frame)
    log-likelihoods, log_trans (B, Q, Q) (from, to) -> gamma (B, Q, N)."""
    B, Q, N = L.shape
    Ln = L.mT                                                 # (B, N, Q)
    alphas = torch.empty((B, N, Q), dtype=L.dtype, device=L.device)
    alphas[:, 0] = _log_pi(L) + Ln[:, 0]
    for n in range(1, N):
        alphas[:, n] = torch.logsumexp(
            alphas[:, n - 1, :, None] + log_trans, dim=1) + Ln[:, n]
    betas = torch.empty_like(alphas)
    betas[:, N - 1] = 0.0
    for n in range(N - 2, -1, -1):
        betas[:, n] = torch.logsumexp(
            log_trans + (Ln[:, n + 1] + betas[:, n + 1])[:, None, :], dim=2)
    post = alphas + betas                                     # (B, N, Q)
    post = post - torch.logsumexp(post, dim=2, keepdim=True)
    return torch.exp(post).mT                                 # (B, Q, N)


def viterbi_decode(delta0: torch.Tensor, Ln: torch.Tensor,
                   log_trans: torch.Tensor) -> torch.Tensor:
    """MAP path of a chain: initial scores delta0 (B, Q), per-frame scores
    Ln (B, N, Q) (frame 0's already in delta0) and transition scores
    log_trans (B, Q, Q) or (Q, Q), (from, to). Returns (B, N) int64.

    The forward pass carries the best score per state and records the
    argmax predecessors (the first maximum, as jnp.argmax picks it); the
    backtrack runs on the device, one gather per frame.
    """
    B, N, Q = Ln.shape
    delta = delta0
    psis = torch.empty((B, max(N - 1, 0), Q), dtype=torch.int64,
                       device=Ln.device)
    for n in range(1, N):
        best, psis[:, n - 1] = torch.max(delta[:, :, None] + log_trans,
                                         dim=1)
        delta = best + Ln[:, n]
    path = torch.empty((B, N), dtype=torch.int64, device=Ln.device)
    path[:, N - 1] = torch.argmax(delta, dim=1)
    for n in range(N - 2, -1, -1):
        path[:, n] = torch.gather(psis[:, n], 1, path[:, n + 1, None])[:, 0]
    return path


def viterbi_path(L: torch.Tensor, log_trans: torch.Tensor) -> torch.Tensor:
    """MAP state sequence, the argmax dual of forward-backward.

    L (B, Q, N) per-(state, frame) log-likelihoods; log_trans (B, Q, Q).
    Returns the hard path (B, N) int64, from a uniform initial state.
    """
    Ln = L.mT                                                 # (B, N, Q)
    return viterbi_decode(_log_pi(L) + Ln[:, 0], Ln, log_trans)


def state_factor_update(comp: SpectralComp, P: torch.Tensor,
                        V: torch.Tensor, eps: float = 1e-30
                        ) -> Tuple[SpectralComp, torch.Tensor]:
    """GMM/HMM replacement for the NMF TW update.

    The component's states are the columns of W = FB @ FW (B, F, Q); TW
    (B, Q, N) becomes gamma(q,n) * g(q,n), posterior-weighted per-frame
    gains. With comp.decode == 'viterbi' (HMM only) gamma is the one-hot
    MAP path. Free FB/FW factors are updated by their NMF rules in
    mstep.update_spectral BEFORE this call; TB must be None. Returns the
    updated component and V with its power replaced.
    """
    if comp.TB is not None:
        raise ValueError("GMM/HMM spectral components must have TB=None")
    vk = comp.power()
    W = comp.freq_pattern()                                   # (B, F, Q)
    B, _, Q = W.shape
    g, L = _state_gains_and_loglik(P, W, eps)
    if comp.constraint == GMM:
        prior = comp.trans if comp.trans is not None else torch.full(
            (B, Q), 1.0 / Q, dtype=P.dtype, device=P.device)
        gamma = _gmm_posteriors(L, torch.log(torch.clamp(prior, min=eps)))
    elif comp.constraint == HMM:
        trans = comp.trans if comp.trans is not None else torch.full(
            (B, Q, Q), 1.0 / Q, dtype=P.dtype, device=P.device)
        log_trans = torch.log(torch.clamp(trans, min=eps))
        if comp.decode == "viterbi":
            path = viterbi_path(L, log_trans)
            gamma = torch.nn.functional.one_hot(path, Q).to(P.dtype).mT
        else:
            gamma = _hmm_posteriors(L, log_trans)
    else:
        raise ValueError(f"not a state constraint: {comp.constraint}")
    TW = torch.clamp(gamma * g, min=eps)                      # (B, Q, N)
    comp = comp.replace(TW=TW)
    return comp, V - vk + comp.power()
