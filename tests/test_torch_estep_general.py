"""The general E-step kernel's plain version against the JAX package.

cuda_estep.estep_ref, reached through suff_stats_cuda on CPU tensors
(complex mixing, rank 2, mixed ranks, noise injection, and real rank 2 with
noise injection), against the JAX Pallas kernel in interpret mode and
against the JAX XLA E-step (compute_suff_stats), at the cases and
tolerances of tests/test_pallas_estep.py; and estep_ref with no_ll
(variant f) against pallas_estep(..., no_ll=True). The CUDA kernel itself
is held against this plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py.
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
from pyfasst_tpu_torch.ops import cuda_estep
from tests.torch_parity import batched, jax_problem, to_torch_params

torch.set_num_threads(1)

_j_suff_stats = jax.jit(j_suff_stats, static_argnames=("ranks",
                                                       "noise_inject"))

# tests/test_pallas_estep.py: (rtol, atol) per statistic
_BARS_R1 = dict(xi=(2e-4, 1e-6), ll=1e-4, Txs=(2e-4, 1e-4), T4=(2e-4, 1e-5),
                Tss=(2e-4, 1e-4), T7=(2e-4, 1e-4))
_BARS_R2 = dict(xi=(3e-4, 1e-5), ll=1e-4, Txs=(5e-4, 1e-3), T4=(5e-4, 1e-4),
                Tss=(5e-4, 1e-3), T7=(5e-4, 1e-3))
_BARS_J3 = dict(_BARS_R2, xi=(3e-4, 1e-6))
_BARS_NS = dict(xi=(3e-4, 1e-6), ll=1e-4, Txs=(5e-4, 1e-4), T4=(5e-4, 1e-4),
                Tss=(5e-4, 1e-4), T7=(5e-4, 1e-3))
_BARS_REAL_NS = dict(xi=(2e-4, 1e-6), ll=1e-4, Txs=(5e-4, 1e-4),
                     T4=(2e-4, 1e-5), Tss=(2e-4, 1e-4), T7=(5e-4, 1e-3))

# name: (J, ranks, mix_type, F, N, noise_inject, real_cov, bars)
CASES = {
    "complex_r1_J2": (2, (1, 1), "conv", 33, 70, False, False, _BARS_R1),
    "complex_r1_J3": (3, (1, 1, 1), "conv", 17, 40, False, False, _BARS_J3),
    "rank2_J2": (2, (2, 2), "conv", 21, 50, False, False, _BARS_R2),
    "rank2_J4": (4, (2, 2, 2, 2), "conv", 21, 50, False, False, _BARS_R2),
    "mixed_1_2": (2, (1, 2), "inst", 17, 40, False, False, _BARS_R2),
    "ns_inj": (2, (1, 1), "inst", 17, 40, True, False, _BARS_NS),
    "real_rank2_ns_inj": (2, (2, 1), "real", 17, 40, True, True,
                          _BARS_REAL_NS),
    # the configurations chip_smoke.py times, and an N that is not a
    # multiple of the CUDA kernel's 32-frame tile
    "mixed_1221_J4": (4, (1, 2, 2, 1), "conv", 21, 50, False, False,
                      _BARS_R2),
    "ns_inj_rank2_J4": (4, (2, 2, 2, 2), "conv", 21, 50, True, False,
                        _BARS_R2),
    "complex_r1_J3_N33": (3, (1, 1, 1), "conv", 17, 33, False, False,
                          _BARS_J3),
}


def _case_inputs(name):
    J, ranks, mix, F, N, ns, real, _ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    X, jparams, sigma = jax_problem(rng, F=F, N=N, J=J,
                                    mix_type="conv" if mix == "real"
                                    else mix, ranks=ranks)
    if mix == "real":
        # source 0 rank-2 with real mixing, the others real rank 1
        # (test_pallas_estep_real_cov_rank2_ns_inj)
        spat = [jparams.spat[0].replace(A=jnp.asarray(
            np.abs(rng.standard_normal((F, 2, 2))) + 0.3, jnp.complex64))]
        for c in jparams.spat[1:]:
            spat.append(c.replace(A=jnp.asarray(
                np.abs(np.asarray(c.A).real) + 0.3, jnp.complex64)))
        jparams = jparams.replace(spat=tuple(spat))
    jv = jparams.all_source_powers()
    jA = tuple(j_conv_A(c, F) for c in jparams.spat)
    jin = (jnp.asarray(X), jv, j_spatial_covs(jparams, F),
           jnp.asarray(sigma), jA)
    tp = to_torch_params(jparams)
    tin = (batched(X), tp.all_source_powers(), batched(sigma),
           tuple(c.conv_mixing(F) for c in tp.spat))
    return jin, tin, ranks, ns, real


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _compare_stats(got, want, J, bars):
    _close(got.xi, want.xi, *bars["xi"])
    np.testing.assert_allclose(float(got.loglik[0]), float(want.loglik),
                               rtol=bars["ll"])
    for j in range(J):
        _close(got.Txs[j], want.Txs[j], *bars["Txs"])
        _close(got.T4[j], want.T4[j], *bars["T4"])
        for k in range(J):
            _close(got.Tss[j][k], want.Tss[j][k], *bars["Tss"])
            if j != k:
                _close(got.T7[j][k], want.T7[j][k], *bars["T7"])
            else:
                assert got.T7[j][k] is None


def _port_stats(tin, ranks, ns, real):
    launches = cuda_estep.LAUNCHES
    got = cuda_estep.suff_stats_cuda(tin[0], tin[1], None, tin[2], ranks,
                                     tin[3], noise_inject=ns, real_cov=real)
    assert cuda_estep.LAUNCHES == launches        # CPU: the plain version
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_general_plain_version_matches_pallas(name):
    jin, tin, ranks, ns, real = _case_inputs(name)
    want = pallas_suff_stats(jin[0], jin[1], jin[2], jin[3], ranks, jin[4],
                             noise_inject=ns, interpret=True, real_cov=real)
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, want, len(ranks), CASES[name][-1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_suff_stats_cuda_matches_xla_estep(name):
    jin, tin, ranks, ns, real = _case_inputs(name)
    want = _j_suff_stats(*jin[:4], ranks, noise_inject=ns, A_conv=jin[4])
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, want, len(ranks), CASES[name][-1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_ll_plain_version_matches_pallas(name):
    """Variant f: the packed outputs of estep_ref(no_ll=True) against
    pallas_estep(no_ll=True) on the same packed inputs."""
    jin, tin, ranks, ns, real = _case_inputs(name)
    bars = CASES[name][-1]
    x4 = cuda_estep.pack_x4(tin[0])
    A4 = cuda_estep.pack_A4(tin[3], ranks)
    want = pallas_estep(jnp.asarray(x4[0].numpy()), jin[1],
                        jnp.asarray(A4[0].numpy()), jin[3], ranks=ranks,
                        ns_inj=ns, no_ll=True, real_cov=real, interpret=True)
    got = cuda_estep.estep_general(x4, tin[1], A4, tin[2], ranks, ns_inj=ns,
                                   real_cov=real, no_ll=True)
    with_ll = cuda_estep.estep_general(x4, tin[1], A4, tin[2], ranks,
                                       ns_inj=ns, real_cov=real)
    for stat, g, w, a in zip(("xi", "Txs", "Tss", "T4", "T7"), got, want,
                             with_ll):
        assert torch.equal(g, a)
        _close(g, w, *bars[stat])
    np.testing.assert_allclose(-float(got[5].sum()), float(want[5]),
                               rtol=bars["ll"])
    assert not torch.equal(got[5], with_ll[5])


def test_plain_version_layout_and_padding():
    """Blocks indexed by the actual ranks, zero past them; Tss_kj is
    Tss_jk^H."""
    rng = np.random.default_rng(4)
    B, J, F, N, ranks = 2, 3, 5, 30, (1, 2, 1)
    x4 = torch.as_tensor(rng.standard_normal((B, 4, F, N)),
                         dtype=torch.float32)
    v = torch.as_tensor(0.5 + rng.random((B, J, F, N)), dtype=torch.float32)
    A = [torch.as_tensor(rng.standard_normal((B, F, 2, r))
                         + 1j * rng.standard_normal((B, F, 2, r)),
                         dtype=torch.complex64) for r in ranks]
    A4 = cuda_estep.pack_A4(A, ranks)
    assert A4.shape == (B, J, F, 8)
    assert torch.all(A4[:, 0, :, 4:] == 0) and torch.all(A4[:, 2, :, 4:] == 0)
    sigma = torch.full((B, F), 0.02)
    xi, txs, tss, t4, t7, ll = cuda_estep.estep_general(
        x4, v, A4, sigma, ranks, ns_inj=True)
    assert [tuple(t.shape) for t in (xi, txs, tss, t4, t7, ll)] == [
        (B, J, F, N), (B, J, F, 8), (B, J, J, F, 8), (B, J, F, 4),
        (B, J, J, F, 8), (B, F)]
    assert torch.all(txs[:, 0, :, 4:] == 0) and torch.all(t4[:, 0, :, 1:] == 0)
    assert torch.all(tss[:, 0, 2, :, 2:] == 0)          # 1 x 1 block
    assert torch.all(tss[:, 0, 1, :, 4:] == 0)          # 1 x 2 block
    assert torch.all(t7[:, 1, 1] == 0)
    blk = torch.complex(tss[..., 0::2], tss[..., 1::2])
    torch.testing.assert_close(blk[:, 1, 0, :, :2], blk[:, 0, 1, :, :2].conj(),
                               rtol=1e-5, atol=1e-6)
    stats = cuda_estep.unpack_stats((xi, txs, tss, t4, t7, ll), ranks)
    assert stats.Txs[1].shape == (B, F, 2, 2) and stats.T4[1].shape == (B, F, 4)
    assert stats.Tss[0][1].shape == (B, F, 1, 2) and stats.T7[1][1] is None
