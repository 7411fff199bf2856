"""E-step of the port against the JAX package.

1. pyfasst_tpu_torch.ops.estep.compute_suff_stats (the CPU path of
   gem_step) against pyfasst_tpu.ops.estep.compute_suff_stats, every
   branch, J = 2 and 3. Both evaluate the same float32 formulas; they
   differ in the order of the frame sums and einsums, and jitted XLA fuses
   multiply-adds, so each statistic is held at rtol 1e-4 (measured up to
   2.6e-5) with an absolute floor of 2e-6 of its largest entry.
2. The kernel's plain version (cuda_estep.estep_r1_real_ref, reached
   through suff_stats_cuda on CPU tensors) against the JAX Pallas kernel in
   interpret mode, at the shapes and tolerances of
   tests/test_pallas_estep.py; with no_ll (variant f) against
   pallas_estep(..., no_ll=True).
   fast_recip (variant e) changes nothing on the CPU: the plain version
   divides exactly, as the Pallas kernel does in interpret mode.
The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.ops.estep import compute_suff_stats as j_suff_stats
from pyfasst_tpu.ops.gem import spatial_covs as j_spatial_covs
from pyfasst_tpu.ops.mstep import _as_conv_A as j_conv_A
from pyfasst_tpu.ops.pallas_estep import pallas_estep, pallas_suff_stats
from pyfasst_tpu_torch.ops import cuda_estep, estep, gem
from tests.torch_parity import batched, jax_problem, to_torch_params

torch.set_num_threads(1)

# jitted: one XLA compile per test instead of one per primitive
_j_suff_stats = jax.jit(j_suff_stats, static_argnames=("ranks",
                                                       "noise_inject"))


def _inputs(X, jparams, sigma):
    """Both packages' E-step inputs from one problem."""
    F = X.shape[0]
    jv = jparams.all_source_powers()
    jin = (jnp.asarray(X), jv, j_spatial_covs(jparams, F), jnp.asarray(sigma),
           tuple(j_conv_A(c, F) for c in jparams.spat))
    tp = to_torch_params(jparams)
    tin = (batched(X), tp.all_source_powers(), gem.spatial_covs(tp, F),
           batched(sigma), tuple(c.conv_mixing(F) for c in tp.spat))
    ranks = tuple(c.rank for c in tp.spat)
    return jin, tin, ranks


def _close(got, want, rtol, atol=None, floor=2e-6):
    """got (1, ...) torch vs want (...) JAX; atol defaults to `floor` of the
    largest |want|."""
    w = np.asarray(want)
    g = got[0].numpy()
    if atol is None:
        atol = floor * float(np.max(np.abs(w))) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _compare(got, want, J, rtol=1e-4):
    _close(got.xi, want.xi, rtol)
    np.testing.assert_allclose(float(got.loglik[0]), float(want.loglik),
                               rtol=rtol)
    for j in range(J):
        _close(got.Txs[j], want.Txs[j], rtol)
        _close(got.T4[j], want.T4[j], rtol)
        for k in range(J):
            _close(got.Tss[j][k], want.Tss[j][k], rtol)
            if j != k:
                _close(got.T7[j][k], want.T7[j][k], rtol)
            else:
                assert got.T7[j][k] is None


VARIANTS = {
    "rank1_inst": dict(mix_type="inst"),
    "rank1_conv": dict(mix_type="conv"),
    "rank2": dict(mix_type="conv", full_rank=True),
    "mixed_ranks": dict(mix_type="inst", mixed=True),
    "noise_inject": dict(mix_type="inst", noise_inject=True),
    "noise_inject_rank2": dict(mix_type="conv", full_rank=True,
                               noise_inject=True),
}


@pytest.mark.parametrize("J", [2, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_compute_suff_stats_matches_jax(variant, J):
    opts = VARIANTS[variant]
    ranks = ((2,) * J if opts.get("full_rank")
             else tuple(1 + (j % 2) for j in range(J)) if opts.get("mixed")
             else (1,) * J)
    rng = np.random.default_rng(J * 100 + len(variant))
    X, jparams, sigma = jax_problem(rng, F=17, N=40, J=J,
                                    mix_type=opts["mix_type"], ranks=ranks)
    jin, tin, ranks = _inputs(X, jparams, sigma)
    ns = opts.get("noise_inject", False)
    want = _j_suff_stats(*jin[:4], ranks, noise_inject=ns, A_conv=jin[4])
    got = estep.compute_suff_stats(*tin[:4], ranks, noise_inject=ns,
                                   A_conv=tin[4])
    _compare(got, want, J)


def test_compute_suff_stats_clip_axis():
    """Two clips in one call give each clip's single-clip statistics."""
    rng = np.random.default_rng(7)
    tins = []
    for _ in range(2):
        X, jparams, sigma = jax_problem(rng, F=9, N=20)
        tins.append(_inputs(X, jparams, sigma)[1])
    cat = [torch.cat([a, b]) for a, b in zip(tins[0][:4], tins[1][:4])]
    A = tuple(torch.cat([a, b]) for a, b in zip(tins[0][4], tins[1][4]))
    both = estep.compute_suff_stats(*cat, (1, 1), A_conv=A)
    for b in range(2):
        one = estep.compute_suff_stats(*tins[b][:4], (1, 1), A_conv=tins[b][4])
        torch.testing.assert_close(both.xi[b:b + 1], one.xi, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(both.loglik[b:b + 1], one.loglik,
                                   rtol=1e-6, atol=0)


# -- the kernel's plain version against the Pallas kernel (interpret mode) ----

# tests/test_pallas_estep.py: (rtol, atol) per statistic
PALLAS_TOL = {
    (33, 70, 2): dict(xi=(2e-4, 1e-6), ll=1e-4, Txs=(2e-4, 1e-4),
                      T4=(2e-4, 1e-5), Tss=(2e-4, 1e-4), T7=(2e-4, 1e-4)),
    (9, 2500, 2): dict(xi=(2e-4, 1e-6), ll=2e-4, Txs=(5e-4, 1e-3),
                       T4=(5e-4, 1e-4), Tss=(5e-4, 1e-3), T7=(5e-4, 1e-3)),
    (17, 40, 3): dict(xi=(3e-4, 1e-6), ll=1e-4, Txs=(5e-4, 1e-3),
                      T4=(5e-4, 1e-4), Tss=(5e-4, 1e-3), T7=(5e-4, 1e-3)),
}


@pytest.mark.parametrize("F,N,J", sorted(PALLAS_TOL))
def test_plain_kernel_version_matches_pallas(F, N, J):
    tol = PALLAS_TOL[(F, N, J)]
    rng = np.random.default_rng(F + N)
    X, jparams, sigma = jax_problem(rng, F=F, N=N, J=J)
    jin, tin, ranks = _inputs(X, jparams, sigma)
    want = pallas_suff_stats(jin[0], jin[1], jin[2], jin[3], ranks, jin[4],
                             interpret=True, real_cov=True)
    launches = cuda_estep.LAUNCHES
    got = cuda_estep.suff_stats_cuda(tin[0], tin[1], None, tin[3], ranks,
                                     tin[4], real_cov=True)
    assert cuda_estep.LAUNCHES == launches        # CPU: the plain version
    _close(got.xi, want.xi, *tol["xi"])
    np.testing.assert_allclose(float(got.loglik[0]), float(want.loglik),
                               rtol=tol["ll"])
    for j in range(J):
        _close(got.Txs[j], want.Txs[j], *tol["Txs"])
        _close(got.T4[j], want.T4[j], *tol["T4"])
        for k in range(J):
            _close(got.Tss[j][k], want.Tss[j][k], *tol["Tss"])
            if j != k:
                _close(got.T7[j][k], want.T7[j][k], *tol["T7"])


@pytest.mark.parametrize("F,N,J", sorted(PALLAS_TOL))
def test_no_ll_plain_version_matches_pallas(F, N, J):
    """Variant f: the loglik without log det Sigma_x; every other output
    as with it."""
    tol = PALLAS_TOL[(F, N, J)]
    rng = np.random.default_rng(F * N)
    X, jparams, sigma = jax_problem(rng, F=F, N=N, J=J)
    _, tin, ranks = _inputs(X, jparams, sigma)
    x4 = cuda_estep.pack_x4(tin[0])
    A = cuda_estep.mixing_columns(tin[4])                   # (1, J, F, 2)
    A4 = torch.stack([A[..., 0], torch.zeros_like(A[..., 0]), A[..., 1],
                      torch.zeros_like(A[..., 0])], dim=-1)
    want = pallas_estep(jnp.asarray(x4[0].numpy()), jnp.asarray(tin[1][0]),
                        jnp.asarray(A4[0].numpy()), jnp.asarray(sigma),
                        ranks=ranks, no_ll=True, real_cov=True,
                        interpret=True)
    got = cuda_estep.estep_r1_real(x4, tin[1], A, tin[3], no_ll=True)
    with_ll = cuda_estep.estep_r1_real(x4, tin[1], A, tin[3])
    for name, g, w, a in zip(("xi", "Txs", "Tss", "T4", "T7"), got, want,
                             with_ll):
        assert torch.equal(g, a)
        _close(g, w, *tol[name])
    np.testing.assert_allclose(-float(got[5].sum()), float(want[5]),
                               rtol=tol["ll"])
    assert not torch.equal(got[5], with_ll[5])


def test_kernel_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    x4 = torch.as_tensor(rng.standard_normal((2, 4, 5, 30)),
                         dtype=torch.float32)
    v = torch.as_tensor(0.5 + rng.random((2, 2, 5, 30)), dtype=torch.float32)
    A = torch.as_tensor(0.3 + rng.random((2, 2, 5, 2)), dtype=torch.float32)
    sigma = torch.as_tensor(0.01 + rng.random((2, 5)) * 0.01,
                            dtype=torch.float32)
    launches = cuda_estep.LAUNCHES
    got = cuda_estep.estep_r1_real(x4, v, A, sigma)
    want = cuda_estep.estep_r1_real_ref(x4, v, A, sigma)
    assert cuda_estep.LAUNCHES == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    shapes = [(2, 2, 5, 30), (2, 2, 5, 4), (2, 2, 2, 5, 2), (2, 2, 5, 4),
              (2, 2, 2, 5, 2), (2, 5)]
    assert [tuple(g.shape) for g in got] == shapes


# Variants b (complex mixing), c (rank 2) and d (ann_ns_inj) and J = 4 to
# 16 run in the general kernel, J = 17 and up in csrc/estep_many.cu, e
# (fast_recip) in either kernel; float64 has no kernel.
_PORTED = ("rank 2", "complex mixing", "ann_ns_inj", "fast_recip", "J = 4",
           "J = 5", "J = 8", "J = 9", "J = 17")


@pytest.mark.parametrize("why,kw", [
    ("rank 2", dict(ranks=(2, 1))),
    ("complex mixing", dict(real_cov=False)),
    ("ann_ns_inj", dict(noise_inject=True)),
    ("fast_recip", dict(fast_recip=True)),
    ("float64", dict(dtype=torch.float64)),
    ("J = 4", dict(ranks=(1, 1, 1, 1))),
    ("J = 5", dict(ranks=(1, 2, 1, 1, 1))),
    ("J = 8", dict(ranks=(2,) * 8)),
    ("J = 9", dict(ranks=(1,) * 9)),
    ("J = 17", dict(ranks=(1,) * 17)),
])
def test_kernel_eligibility_names_the_variant(why, kw):
    args = dict(ranks=(1, 1), real_cov=True, noise_inject=False,
                dtype=torch.float32, fast_recip=False, I=2)
    assert cuda_estep.kernel_eligible(**args) == ""
    args.update(kw)
    reason = cuda_estep.kernel_eligible(**args)
    if why in _PORTED:
        assert reason == ""
    else:
        assert why.split()[0] in reason and "ROADMAP" in reason


def test_suff_stats_cuda_raises_for_variants_not_ported():
    rng = np.random.default_rng(5)
    X, jparams, sigma = jax_problem(rng, F=9, N=20, mix_type="conv")
    _, tin, ranks = _inputs(X, jparams, sigma)
    launches = cuda_estep.LAUNCHES
    for kw in (dict(real_cov=False), dict(real_cov=True, noise_inject=True)):
        # computed now (by the plain version, on CPU tensors)
        stats = cuda_estep.suff_stats_cuda(tin[0], tin[1], None, tin[3],
                                           ranks, tin[4], **kw)
        assert bool(torch.isfinite(stats.xi).all())
    # fast_recip is computed too; on the CPU the plain version divides
    # exactly, so it changes nothing there
    exact = cuda_estep.suff_stats_cuda(tin[0], tin[1], None, tin[3], ranks,
                                       tin[4])
    fast = cuda_estep.suff_stats_cuda(tin[0], tin[1], None, tin[3], ranks,
                                      tin[4], fast_recip=True)
    assert torch.equal(exact.xi, fast.xi)
    assert torch.equal(exact.loglik, fast.loglik)
    assert cuda_estep.LAUNCHES == launches
    with pytest.raises(NotImplementedError, match="float64"):
        cuda_estep.suff_stats_cuda(tin[0], tin[1].double(), None, tin[3],
                                   ranks, tin[4])
    # J = 17 goes to csrc/estep_many.cu on CUDA: on the CPU, its plain
    # version, with no launch
    many = (tin[4] * 9)[:17]
    stats = cuda_estep.suff_stats_cuda(tin[0], tin[1][:, [0, 1] * 8 + [0]],
                                       None, tin[3], (1,) * 17, many)
    assert stats.xi.shape[1] == 17 and len(stats.Tss) == 17
    assert bool(torch.isfinite(stats.xi).all())
    assert cuda_estep.LAUNCHES == launches


# -- the symmetries the rank-1 real CUDA kernel relies on ----------------------
#
# csrc/estep.cu carries only the distinct frame sums (Re Tss_jk for j <= k,
# Im Tss_jk for j < k) and writes the mirrored words from them, and writes
# Im Tss_jj, t4[1:4], Im T7 and T7_jj as constant zeros. That changes no bit
# of what the plain version (the kernel's contract on the card) produces,
# which these tests hold for J = 2 and 3 and each flag. The Pallas kernel in
# interpret mode gives the same zeros and the same Re Tss_kj = Re Tss_jk bit
# for bit; its Im Tss_kj equals -Im Tss_jk only to rounding (up to 4e-5
# relative here), because XLA's CPU compiler contracts
# wi_j wr_k - wr_j wi_k into a fused multiply-add, which is not
# antisymmetric in (j, k). The port's kernels are built without contraction.

def _r1_problem(J, seed, F=11, N=150):
    rng = np.random.default_rng(seed)
    x4 = rng.standard_normal((1, 4, F, N)).astype(np.float32)
    v = (0.5 + 4 * rng.random((1, J, F, N))).astype(np.float32)
    A = (0.3 + rng.random((1, J, F, 2))).astype(np.float32)
    sigma = (0.01 + 0.005 * rng.random((1, F))).astype(np.float32)
    return x4, v, A, sigma


def _r1_outputs(which, J, flag, seed):
    """(tss, t4, t7) as numpy, (J, J, F, 2), (J, F, 4), (J, J, F, 2)."""
    x4, v, A, sigma = _r1_problem(J, seed)
    if which == "plain":
        out = cuda_estep.estep_r1_real_ref(
            *(torch.as_tensor(a) for a in (x4, v, A, sigma)),
            no_ll=flag == "no_ll")
        return tuple(out[i][0].numpy() for i in (2, 3, 4))
    A4 = np.stack([A[..., 0], np.zeros_like(A[..., 0]), A[..., 1],
                   np.zeros_like(A[..., 0])], axis=-1)
    out = pallas_estep(jnp.asarray(x4[0]), jnp.asarray(v[0]),
                       jnp.asarray(A4[0]), jnp.asarray(sigma[0]),
                       ranks=(1,) * J, real_cov=True, interpret=True,
                       no_ll=flag == "no_ll", fast_recip=flag == "fast_recip")
    return tuple(np.asarray(out[i]) for i in (2, 3, 4))


@pytest.mark.parametrize("flag", ["", "fast_recip", "no_ll"])
@pytest.mark.parametrize("J", [2, 3])
@pytest.mark.parametrize("which", ["plain", "pallas"])
def test_rank1_real_sums_are_mirrored_bit_for_bit(which, J, flag):
    tss, t4, t7 = _r1_outputs(which, J, flag, seed=10 * J + len(flag))
    for j in range(J):
        assert np.all(tss[j, j, :, 1] == 0)            # Im Tss_jj
        assert np.all(t7[j, j] == 0)                   # no T7_jj
        for k in range(J):
            # Tss_kj = conj(Tss_jk), every bit
            assert np.array_equal(tss[k, j, :, 0], tss[j, k, :, 0])
            if which == "plain":
                assert np.array_equal(tss[k, j, :, 1], -tss[j, k, :, 1])
            else:
                np.testing.assert_allclose(tss[k, j, :, 1], -tss[j, k, :, 1],
                                           rtol=2e-4, atol=1e-4)
            if j != k:
                assert np.all(tss[j, k, :, 1] != 0)    # a real test of the sign
    assert np.all(t4[..., 1:] == 0)                    # rank 1: one word of 4
    assert np.all(t7[..., 1] == 0)                     # real mixing: Im T7


@pytest.mark.parametrize("J", [2, 3])
@pytest.mark.parametrize("which", ["plain", "pallas"])
def test_rank1_real_t7_is_not_mirrored_bit_for_bit(which, J):
    """The recorded answer: T7_jk = v_j v_k A_j^T Sigma_x^-1 A_k equals T7_kj
    in exact arithmetic, but A_j^T (Sigma_x^-1 A_k) and A_k^T (Sigma_x^-1
    A_j) round differently, in the plain version as in the Pallas kernel;
    so the CUDA kernel carries both sums. They agree to rounding."""
    _, _, t7 = _r1_outputs(which, J, "", seed=20 + J)
    differing = 0
    for j in range(J):
        for k in range(j + 1, J):
            np.testing.assert_allclose(t7[j, k, :, 0], t7[k, j, :, 0],
                                       rtol=1e-4)
            differing += int(np.sum(t7[j, k, :, 0] != t7[k, j, :, 0]))
    assert differing > 0


@pytest.mark.parametrize("J,ill", [(1, True), (17, False)])
def test_one_source_amplifies_a_reciprocal_ulp(monkeypatch, J, ill):
    """Why variant e (fast_recip, ~1 ulp from 1/x) is not held at xi's
    2e-4 bar with one source: Sigma_x = sigma I + v_1 R_1 is so
    ill-conditioned that one ulp more in every reciprocal of the plain
    version moves xi past the bar (chip_smoke.many_variants divides exactly
    there); at 17 sources it stays far inside."""
    rng = np.random.default_rng(J)
    B, F, N = 1, 33, 70
    FB, TW = 0.5 + rng.random((B, J, F, 8)), 0.5 + rng.random((B, J, 8, N))
    A4 = 0.7 * rng.standard_normal((B, J, F, 4))
    inp = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((B, 4, F, N)),
        np.einsum("bjfk,bjkn->bjfn", FB, TW), A4,
        0.01 + 0.005 * rng.random((B, F)))]
    want = cuda_estep.estep_ref(*inp, (1,) * J)[0]
    exact = torch.Tensor.__rtruediv__

    def one_ulp_more(self, other):
        r = exact(self, other)
        if isinstance(other, float) and other == 1.0:
            return torch.nextafter(r, torch.full_like(r, float("inf")))
        return r

    monkeypatch.setattr(torch.Tensor, "__rtruediv__", one_ulp_more)
    got = cuda_estep.estep_ref(*inp, (1,) * J)[0]
    floor = 1e-3 * float(want.abs().max())
    rel = float(((got - want).abs() / (want.abs() + floor)).max())
    assert (rel > 2e-4) == ill
