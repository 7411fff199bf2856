"""M-step of the port against the JAX package, on the same E-step
statistics and parameters.

float32: rtol 2e-5 with a floor of 1e-6 of the largest entry (the frequency
pools and matrix products sum in different orders). float64 (JAX under
enable_x64): rtol 1e-9, the same arithmetic to rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from pyfasst_tpu.models.components import (
    FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_tpu.ops import mstep as jm
from pyfasst_tpu.ops.estep import compute_suff_stats as j_suff_stats
from pyfasst_tpu.ops.gem import spatial_covs as j_spatial_covs
from pyfasst_tpu_torch.ops import estep, mstep
from tests.torch_parity import batched, jax_problem, to_torch_params

torch.set_num_threads(1)

TOL = {np.float32: (2e-5, 1e-6), np.float64: (1e-9, 1e-12)}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
# jitted: one XLA compile per test instead of one per primitive
_j_stats = jax.jit(j_suff_stats, static_argnames=("ranks",))
_j_spatial = jax.jit(jm.update_spatial)
_j_spectral = jax.jit(jm.update_spectral)
_j_renormalize = jax.jit(jm.renormalize)


def _stats(X, jparams, sigma):
    """JAX E-step statistics and the same numbers as a torch SuffStats."""
    F = X.shape[0]
    ranks = tuple(c.rank for c in jparams.spat)
    js = _j_stats(jnp.asarray(X), jparams.all_source_powers(),
                  j_spatial_covs(jparams, F), jnp.asarray(sigma), ranks,
                  A_conv=tuple(jm._as_conv_A(c, F) for c in jparams.spat))

    def t(a):
        return None if a is None else batched(a)

    ts = estep.SuffStats(
        xi=t(js.xi), Txs=tuple(t(a) for a in js.Txs),
        Tss=tuple(tuple(t(a) for a in r) for r in js.Tss),
        T4=tuple(t(a) for a in js.T4),
        T7=tuple(tuple(t(a) for a in r) for r in js.T7),
        loglik=t(js.loglik))
    return js, ts


def _close(got, want, dtype):
    rtol, floor = TOL[dtype]
    w = np.asarray(want)
    np.testing.assert_allclose(got[0].numpy(), w, rtol=rtol,
                               atol=floor * float(np.max(np.abs(w))))


def _compare_params(tp, jp, dtype):
    for tc, jc in zip(tp.spat, jp.spat):
        _close(tc.A, jc.A, dtype)
    for tc, jc in zip(tp.spec, jp.spec):
        for name in ("FB", "FW", "TW", "TB"):
            if getattr(jc, name) is not None:
                _close(getattr(tc, name), getattr(jc, name), dtype)


def _run(dtype, fn):
    if dtype == np.float64:
        with enable_x64():
            fn()
    else:
        fn()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mix,ranks", [("inst", (1, 1)), ("conv", (1, 1)),
                                       ("conv", (2, 2)), ("inst", (1, 2))])
def test_update_spatial_matches_jax(mix, ranks, dtype):
    def body():
        rng = np.random.default_rng(sum(ranks) + len(mix))
        X, jp, sigma = jax_problem(rng, F=17, N=30, mix_type=mix,
                                   ranks=ranks, dtype=dtype)
        js, ts = _stats(X, jp, sigma)
        want = _j_spatial(jp, js, jnp.asarray(sigma))
        tp = to_torch_params(jp, TDT[dtype])
        got = mstep.update_spatial(tp, ts, batched(sigma))
        _compare_params(got, want, dtype)
        held = mstep.update_spatial(tp, ts, batched(sigma), enabled=False)
        for a, b in zip(held.spat, tp.spat):
            assert a.A is b.A
    _run(dtype, body)


def _chain_params(rng, F, N, dtype):
    """Spectral chains with every factor present: FB (F, L), FW (L, K),
    TW (K, M), TB (M, N); one all-free, one with FB fixed."""
    L, K, M = 4, 3, 6
    spec = []
    for j, free in enumerate([(True, True, True, True),
                              (False, True, True, False)]):
        spec.append(SpectralComp(
            FB=jnp.asarray(0.5 + rng.random((F, L)), dtype),
            FW=jnp.asarray(0.5 + rng.random((L, K)), dtype),
            TW=jnp.asarray(0.5 + rng.random((K, M)), dtype),
            TB=jnp.asarray(0.5 + rng.random((M, N)), dtype),
            spat_ind=j, free=free))
    spat = tuple(SpatialComp(A=jnp.asarray(
        np.abs(rng.standard_normal((2, 1))) + 0.3, dtype)) for _ in range(2))
    return FasstParams(spat=spat, spec=tuple(spec))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("chain", [False, True])
def test_update_spectral_matches_jax(chain, dtype):
    def body():
        rng = np.random.default_rng(21 + chain)
        X, jp, sigma = jax_problem(rng, F=17, N=30, dtype=dtype)
        if chain:
            jp = _chain_params(rng, 17, 30, dtype)
        js, ts = _stats(X, jp, sigma)
        want = _j_spectral(jp, js, v=jp.all_source_powers())
        tp = to_torch_params(jp, TDT[dtype])
        got = mstep.update_spectral(tp, ts, v=tp.all_source_powers())
        _compare_params(got, want, dtype)
    _run(dtype, body)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mix", ["inst", "conv", "chain"])
def test_renormalize_matches_jax(mix, dtype):
    def body():
        rng = np.random.default_rng(31)
        _, jp, _ = jax_problem(rng, F=17, N=30, dtype=dtype,
                               mix_type="inst" if mix == "chain" else mix)
        if mix == "chain":
            jp = _chain_params(rng, 17, 30, dtype)
        # scale the mixing away from unit power so renormalize moves it
        jp = jp.replace(spat=tuple(c.replace(A=c.A * 3.0) for c in jp.spat))
        want = _j_renormalize(jp)
        got = mstep.renormalize(to_torch_params(jp, TDT[dtype]))
        _compare_params(got, want, dtype)
    _run(dtype, body)


def test_update_spectral_not_ported_branches_raise():
    """The HMM, GMM and source-filter (SIMM) branches, which raised until
    they were ported, give the JAX package's update on the same
    statistics. The HMM case decodes by Viterbi: soft posteriors of a
    float32 log-space recursion lie ~1.2e-4 from float64 here in both
    packages (|alpha| ~ 800), past this file's bar; they are held in
    tests/test_torch_hmm.py on well-scaled scores and through GEM runs."""
    rng = np.random.default_rng(41)
    X, jp, sigma = jax_problem(rng, F=9, N=20)
    js, ts = _stats(X, jp, sigma)
    K = jp.spec[0].FB.shape[1]
    trans = 0.8 * np.eye(K) + 0.1 * (1 - np.eye(K))
    cases = (
        jp.spec[0].replace(constraint="HMM", decode="viterbi",
                           trans=jnp.asarray(trans, jnp.float32)),
        jp.spec[0].replace(constraint="GMM",
                           trans=jnp.full((K,), 1.0 / K, jnp.float32)),
        jp.spec[0].replace(FB2=jnp.asarray(0.5 + rng.random((9, 2)),
                                           jnp.float32),
                           TW2=jnp.asarray(0.5 + rng.random((2, 20)),
                                           jnp.float32),
                           free2=(True, True)))
    for comp in cases:
        jq = jp.replace(spec=(comp,) + jp.spec[1:])
        want = jm.update_spectral(jq, js, v=jq.all_source_powers())
        tq = to_torch_params(jq)
        got = mstep.update_spectral(tq, ts, v=tq.all_source_powers())
        _compare_params(got, want, np.float32)
        for name in ("FB2", "TW2"):
            if getattr(want.spec[0], name) is not None:
                _close(getattr(got.spec[0], name),
                       getattr(want.spec[0], name), np.float32)


def test_clip_axis_keeps_clips_apart():
    """The M-step of two stacked clips equals each clip's own M-step."""
    rng = np.random.default_rng(51)
    parts = [jax_problem(rng, F=9, N=20) for _ in range(2)]
    stats = [_stats(*p)[1] for p in parts]
    params = [to_torch_params(p[1]) for p in parts]

    def cat(a, b):
        return None if a is None else torch.cat([a, b])

    ts = estep.SuffStats(
        xi=cat(stats[0].xi, stats[1].xi),
        Txs=tuple(map(cat, stats[0].Txs, stats[1].Txs)),
        Tss=tuple(tuple(map(cat, r0, r1))
                  for r0, r1 in zip(stats[0].Tss, stats[1].Tss)),
        T4=tuple(map(cat, stats[0].T4, stats[1].T4)),
        T7=tuple(tuple(map(cat, r0, r1))
                 for r0, r1 in zip(stats[0].T7, stats[1].T7)),
        loglik=cat(stats[0].loglik, stats[1].loglik))
    tp = params[0].replace(
        spat=tuple(a.replace(A=cat(a.A, b.A))
                   for a, b in zip(params[0].spat, params[1].spat)),
        spec=tuple(a.replace(FB=cat(a.FB, b.FB), TW=cat(a.TW, b.TW))
                   for a, b in zip(params[0].spec, params[1].spec)))
    sigma = torch.cat([batched(p[2]) for p in parts])
    both = mstep.renormalize(mstep.update_spectral(
        mstep.update_spatial(tp, ts, sigma), ts))
    for b in range(2):
        one = mstep.renormalize(mstep.update_spectral(
            mstep.update_spatial(params[b], stats[b], sigma[b:b + 1]),
            stats[b]))
        for cb, c1 in zip(both.spat, one.spat):
            torch.testing.assert_close(cb.A[b:b + 1], c1.A, rtol=1e-6,
                                       atol=0)
        for cb, c1 in zip(both.spec, one.spec):
            torch.testing.assert_close(cb.FB[b:b + 1], c1.FB, rtol=1e-6,
                                       atol=1e-30)
            torch.testing.assert_close(cb.TW[b:b + 1], c1.TW, rtol=1e-6,
                                       atol=1e-30)
