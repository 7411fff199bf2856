"""The fused spectral M-step of the port against the JAX package.

cuda_spectral.fb_stats_ref, tw_stats_ref and fused_spectral_update (the
plain versions the fb_stats and tw_stats wrappers run on CPU tensors)
against pallas_spectral.fb_stats, tw_stats and fused_spectral_update in
interpret mode, at the shapes of tests/test_pallas_spectral.py, with two
distinct clips in one call of the port against two calls of JAX. Bars:
rtol 2e-5, the bar of test_pallas_spectral.py; every output is a sum of
positive terms, so only the order of the sums differs. The short GEM loop
holds test_fused_in_gem_loop_cpu_interpret's bars (loglik rtol 1e-4, FB
rtol 5e-3). The CUDA kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.ops import pallas_spectral
from pyfasst_tpu.ops.estep import compute_suff_stats as j_suff_stats
from pyfasst_tpu.ops.gem import annealing_endpoints as j_endpoints
from pyfasst_tpu.ops.gem import noise_psd as j_noise_psd
from pyfasst_tpu.ops.gem import spatial_covs as j_spatial_covs
from pyfasst_tpu.ops.mstep import _as_conv_A as j_conv_A
from pyfasst_tpu.ops.mstep import renormalize as j_renormalize
from pyfasst_tpu.ops.mstep import update_spatial as j_update_spatial
from pyfasst_tpu.utils.config import GEMConfig as JGEMConfig
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.ops import cuda_spectral, estep, gem, mstep
from pyfasst_tpu_torch.utils.config import GEMConfig
from tests.torch_parity import batched, jax_problem, to_torch_params

torch.set_num_threads(1)

_j_suff_stats = jax.jit(j_suff_stats, static_argnames=("ranks",
                                                       "noise_inject"))

# (J, F, N, K): test_pallas_spectral.py's shapes; one whose F is not a
# multiple of the CUDA fb_stats kernel's 8-row tile and whose N is under
# one warp's 32 frames; and the ones that cross the CUDA tw_stats kernel's
# strips of 16 frames (N = 1, 7, 31, 33) and batches of 128 rows (F = 3
# and 64 below one, 129 one past one), with K = 16 and 32
SHAPES = [(2, 64, 128, 5), (2, 37, 95, 5), (2, 130, 300, 5), (3, 70, 211, 4),
          (2, 13, 29, 8), (2, 3, 1, 8), (2, 13, 31, 16), (2, 129, 33, 32),
          (2, 64, 7, 16)]
RTOL = 2e-5


def _stats_inputs(J, F, N, K, seed):
    """Two clips of (xi, FB, TW, vfloor) as numpy float32: xi scattered
    around V = FB TW; clip 0 takes fused_spectral_update's floor, clip 1 a
    floor at each source's 30th percentile of V, so that the clamp acts."""
    rng = np.random.default_rng(seed)
    FB = (0.5 + rng.random((2, J, F, K))).astype(np.float32)
    TW = (0.5 + rng.random((2, J, K, N))).astype(np.float32)
    V = np.einsum("bjfk,bjkn->bjfn", FB, TW)
    xi = (V * (0.1 + rng.exponential(size=V.shape))).astype(np.float32)
    vfloor = np.stack([1e-12 * xi[0].mean(axis=(1, 2)) + 1e-30,
                       np.quantile(V[1], 0.3, axis=(1, 2))]).astype(np.float32)
    return xi, FB, TW, vfloor


@pytest.mark.parametrize("kernel", ["fb_stats", "tw_stats"])
@pytest.mark.parametrize("J,F,N,K", SHAPES)
def test_plain_version_matches_pallas(kernel, J, F, N, K):
    xi, FB, TW, vfloor = _stats_inputs(J, F, N, K, seed=F * N + J)
    ref = getattr(cuda_spectral, f"{kernel}_ref")
    got = ref(*(torch.as_tensor(a) for a in (xi, FB, TW, vfloor)))
    shape = (2, J, F, K) if kernel == "fb_stats" else (2, J, K, N)
    for b in range(2):
        want = getattr(pallas_spectral, kernel)(
            jnp.asarray(xi[b]), jnp.asarray(FB[b]), jnp.asarray(TW[b]),
            jnp.asarray(vfloor[b][:, None]), interpret=True)
        for g, w in zip(got, want):
            assert tuple(g.shape) == shape
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w),
                                       rtol=RTOL, atol=0)


def _params_and_stats(J, F, N, K, seed):
    """Two clips' JAX params and xi, and the port's (B = 2) of the same
    numbers."""
    rng = np.random.default_rng(seed)
    jps, xis = [], []
    for _ in range(2):
        _, jp, _ = jax_problem(rng, F=F, N=N, J=J, K=K)
        V = np.asarray(jp.all_source_powers())
        xis.append((V * (0.1 + rng.exponential(size=V.shape)))
                   .astype(np.float32))
        jps.append(jp)
    tp = convert.params_from_numpy([jax.tree.map(np.asarray, p) for p in jps])
    tstats = types.SimpleNamespace(xi=torch.as_tensor(np.stack(xis)))
    return jps, xis, tp, tstats


@pytest.mark.parametrize("J,F,N,K", SHAPES)
def test_fused_update_matches_pallas(J, F, N, K):
    jps, xis, tp, tstats = _params_and_stats(J, F, N, K, seed=F + N)
    got = cuda_spectral.fused_spectral_update(tp, tstats)
    for b in range(2):
        want = pallas_spectral.fused_spectral_update(
            jps[b], types.SimpleNamespace(xi=jnp.asarray(xis[b])),
            interpret=True)
        for c_got, c_want in zip(got.spec, want.spec):
            for name in ("FB", "TW"):
                np.testing.assert_allclose(
                    getattr(c_got, name)[b].numpy(),
                    np.asarray(getattr(c_want, name)), rtol=RTOL, atol=1e-30)


@pytest.mark.parametrize("J,F,N,K", SHAPES)
def test_fused_update_matches_update_spectral(J, F, N, K):
    _, _, tp, tstats = _params_and_stats(J, F, N, K, seed=F + N + 1)
    got = cuda_spectral.fused_spectral_update(tp, tstats)
    want = mstep.update_spectral(tp, tstats, v=tp.all_source_powers())
    for c_got, c_want in zip(got.spec, want.spec):
        torch.testing.assert_close(c_got.FB, c_want.FB, rtol=RTOL, atol=1e-30)
        torch.testing.assert_close(c_got.TW, c_want.TW, rtol=RTOL, atol=1e-30)


def _gate_case(case):
    """(JAX params or None, the port's params) for one eligibility case."""
    rng = np.random.default_rng(0)
    _, jp, _ = jax_problem(rng, F=32, N=64, J=2, K=3)
    s0 = jp.spec[0]
    if case == "fixed_FB":          # the ERB-style chain: FB fixed, FW free
        jp = jp.replace(spec=(s0.replace(free=(False, True, True, False)),)
                        + jp.spec[1:])
    elif case == "simm":            # a source-filter second chain
        jp = jp.replace(spec=(s0.replace(FB2=s0.FB, TW2=s0.TW),)
                        + jp.spec[1:])
    elif case == "mismatched_K":
        jp = jp.replace(spec=(s0.replace(
            FB=jnp.asarray(rng.random((32, 7)), jnp.float32),
            TW=jnp.asarray(rng.random((7, 64)), jnp.float32)),)
            + jp.spec[1:])
    elif case == "source_order":
        jp = jp.replace(spec=jp.spec[::-1])
    elif case == "two_per_source":
        jp = jp.replace(spec=jp.spec + (s0,))
    if case == "float64":
        return None, to_torch_params(jp, dtype=torch.float64)
    return jp, to_torch_params(jp)


@pytest.mark.parametrize("case,expected", [
    ("plain", True), ("fixed_FB", False), ("simm", False),
    ("mismatched_K", False), ("source_order", False),
    ("two_per_source", False), ("float64", False)])
def test_eligibility_gates(case, expected):
    jp, tp = _gate_case(case)
    assert cuda_spectral.eligible(tp) is expected
    if jp is not None:
        assert pallas_spectral.eligible(jp) is expected


def test_wrappers_run_the_plain_versions_on_cpu():
    xi, FB, TW, vfloor = (torch.as_tensor(a) for a in
                          _stats_inputs(2, 9, 20, 3, seed=0))
    launches = dict(cuda_spectral.LAUNCHES)
    for name in ("fb_stats", "tw_stats"):
        got = getattr(cuda_spectral, name)(xi, FB, TW, vfloor)
        want = getattr(cuda_spectral, f"{name}_ref")(xi, FB, TW, vfloor)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cuda_spectral.LAUNCHES == launches
    assert cuda_spectral.fb_stats(xi, FB, TW, vfloor)[0].shape == (2, 2, 9, 3)
    assert cuda_spectral.tw_stats(xi, FB, TW, vfloor)[0].shape == (2, 2, 3, 20)


def test_fuse_spectral_changes_nothing_on_cpu():
    """As in the JAX package, whose CPU path runs no Pallas kernel."""
    rng = np.random.default_rng(2)
    X, jp, _ = jax_problem(rng, F=17, N=30)
    tp, Xt = to_torch_params(jp), batched(X)
    outs = [gem.run_gem(tp, Xt, GEMConfig(niter=3, fuse_spectral=fuse))
            for fuse in (False, True)]
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(outs[0][0].spec, outs[1][0].spec):
        assert torch.equal(a.FB, b.FB) and torch.equal(a.TW, b.TW)


def test_fused_gem_loop_tracks_pallas():
    """Six GEM iterations whose spectral step is the fused update, in both
    packages, from the same parameters (test_fused_in_gem_loop_cpu_interpret
    in the port)."""
    F, N, niter = 48, 100, 6
    rng = np.random.default_rng(1)
    X, jp, _ = jax_problem(rng, F=F, N=N, J=2, K=5)
    tp, Xt, Xj = to_torch_params(jp), batched(X), jnp.asarray(X)
    jcfg, tcfg = JGEMConfig(niter=niter, use_pallas=False), GEMConfig(
        niter=niter)
    js0, js1 = j_endpoints(Xj, jcfg)
    ts0, ts1 = gem.annealing_endpoints(Xt, tcfg)
    ranks = (1, 1)
    for it in range(niter):
        sj = j_noise_psd(it, niter, js0, js1, jcfg.annealing)
        jstats = _j_suff_stats(Xj, jp.all_source_powers(),
                               j_spatial_covs(jp, F), sj, ranks,
                               A_conv=tuple(j_conv_A(c, F) for c in jp.spat))
        jp = j_update_spatial(jp, jstats, sj)
        jp = pallas_spectral.fused_spectral_update(jp, jstats,
                                                   interpret=True)
        jp = j_renormalize(jp)

        st = gem.noise_psd(it, niter, ts0, ts1, tcfg.annealing)
        tstats = estep.compute_suff_stats(
            Xt, tp.all_source_powers(), gem.spatial_covs(tp, F), st, ranks,
            A_conv=tuple(c.conv_mixing(F) for c in tp.spat))
        tp = mstep.update_spatial(tp, tstats, st)
        tp = cuda_spectral.fused_spectral_update(tp, tstats)
        tp = mstep.renormalize(tp)
    np.testing.assert_allclose(float(tstats.loglik[0]), float(jstats.loglik),
                               rtol=1e-4)
    for ct, cj in zip(tp.spec, jp.spec):
        np.testing.assert_allclose(ct.FB[0].numpy(), np.asarray(cj.FB),
                                   rtol=5e-3)
