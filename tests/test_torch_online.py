"""The port's online (streaming) GEM against the JAX package.

ops/online.py on both sides, fed the same numpy-made blocks (the port's
tensors carry a clip axis B = 1). Bars, as the E-step suite's: after one
block every state field within 5e-4 of its largest entry (the frame sums'
bar; xi's is 2e-4 and the block's TW passes through six E-steps), TW
within 5e-4 of its peak, loglik rtol 1e-5. After four blocks the same bars
(measured: the worst field 4.3e-4 of its peak, rank-1 I = 2's tss).
Full-rank tss and t7 stay exactly zero on both sides.

The cross posterior statistic t7 is held in float64 (both packages under
enable_x64, every field within 1e-9 of its peak; measured <= 1e-10): in
float32 it is rounding in both packages. On the rank-1 stereo fixture the
JAX package's own float32 t7 lies 1.1e-3 of its peak from its float64 t7
after one block and 1.3e-2 after four (the port's 9.5e-4 and 5.5e-3): T7_jk
= sum v_j v_k A_j^H Sigma_x^-1 A_k of two near-parallel columns is a
difference of large terms, in the reference's formula. It enters the
mixing update only through tss - t7, where tss dominates (A agrees within
2e-5).
"""
from jax import enable_x64
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.ops import online as jonline
from pyfasst_tpu_torch.ops import gem, online

torch.set_num_threads(1)

CASES = {"rank1_I2": (2, False), "rank1_I3": (3, False),
         "fullrank_I2": (2, True)}
STATE_TOL = 5e-4
LL_RTOL = 1e-5
F64_TOL = 1e-9
F32_FIELDS = tuple(n for n in online.OnlineState._fields if n != "t7")


def _problem(case, seed=0, J=2, F=17, K=3, Nb=16, nb=4, dtype=np.float32):
    """X (F, nb * Nb, I), A0, FB0, TW0, sigma as numpy, made from a seed,
    in `dtype` (and its complex dtype)."""
    I, full = CASES[case]
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((F, nb * Nb, I))
         + 1j * rng.standard_normal((F, nb * Nb, I))).astype(np.complex64)
    X[..., 0] *= np.linspace(0.5, 2.0, F)[:, None].astype(np.float32)
    if full:
        A0 = np.zeros((J, F, I, I), np.complex64)
        A0[..., 0] = 0.4 + rng.random((J, F, I))
        A0[..., 1] = 0.1 * rng.random((J, F, I))
    else:
        A0 = (0.4 + rng.random((J, F, I))).astype(np.complex64)
    FB0 = (0.5 + rng.random((J, F, K))).astype(np.float32)
    TW0 = (0.5 + rng.random((J, K, Nb))).astype(np.float32)
    sigma = (0.01 + 0.005 * rng.random(F)).astype(np.float32)
    cdt = np.complex128 if dtype == np.float64 else np.complex64
    return (X.astype(cdt), A0.astype(cdt), FB0.astype(dtype),
            TW0.astype(dtype), sigma.astype(dtype), nb)


def _t(a):
    return torch.as_tensor(np.asarray(a))[None]


def _close(got, want, tol, name):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, name
    peak = np.max(np.abs(want))
    if peak == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    err = np.max(np.abs(got - want)) / peak
    assert err <= tol, f"{name}: {err:.3e} of the peak > {tol:.0e}"


def _compare_state(tstate, jstate, tol=STATE_TOL, fields=F32_FIELDS):
    for name in fields:
        _close(getattr(tstate, name)[0], getattr(jstate, name), tol, name)


def _one_block(case, dtype):
    X, A0, FB0, TW0, sigma, _ = _problem(case, dtype=dtype)
    Nb = TW0.shape[-1]
    Xb = X[:, :Nb]
    jstate, (jTW, jll) = jonline.online_block(
        jonline.online_init(jnp.asarray(A0), jnp.asarray(FB0)),
        jnp.asarray(Xb), jnp.asarray(TW0), jnp.asarray(sigma),
        forgetting=0.95, inner_iters=6)
    tstate, (tTW, tll) = online.online_block(
        online.online_init(_t(A0), _t(FB0)), _t(Xb), _t(TW0), _t(sigma),
        forgetting=0.95, inner_iters=6)
    return (jstate, np.asarray(jTW), float(jll)), (tstate, tTW, tll)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_block_matches_jax(case):
    (jstate, jTW, jll), (tstate, tTW, tll) = _one_block(case, np.float32)
    _compare_state(tstate, jstate)
    _close(tTW[0], jTW, STATE_TOL, "TWb")
    np.testing.assert_allclose(float(tll[0]), jll, rtol=LL_RTOL)
    assert all(t.is_contiguous() for t in tstate)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_block_matches_jax_in_float64(case):
    """Every field, t7 included, in float64: the same arithmetic."""
    with enable_x64():
        (jstate, jTW, jll), (tstate, tTW, tll) = _one_block(case,
                                                            np.float64)
    assert tstate.A.dtype == torch.complex128
    _compare_state(tstate, jstate, F64_TOL, online.OnlineState._fields)
    _close(tTW[0], jTW, F64_TOL, "TWb")
    np.testing.assert_allclose(float(tll[0]), jll, rtol=F64_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_four_blocks_match_jax(case):
    X, A0, FB0, TW0, sigma, nb = _problem(case, seed=1)
    Nb = TW0.shape[-1]
    jstate = jonline.online_init(jnp.asarray(A0), jnp.asarray(FB0))
    tstate = online.online_init(_t(A0), _t(FB0))
    jlls, tlls, jtws, ttws = [], [], [], []
    for b in range(nb):
        Xb = X[:, b * Nb:(b + 1) * Nb]
        jstate, (jTW, jll) = jonline.online_block(
            jstate, jnp.asarray(Xb), jnp.asarray(TW0), jnp.asarray(sigma))
        tstate, (tTW, tll) = online.online_block(
            tstate, _t(Xb), _t(TW0), _t(sigma))
        jlls.append(float(jll))
        tlls.append(float(tll[0]))
        jtws.append(np.asarray(jTW))
        ttws.append(tTW[0])
    _compare_state(tstate, jstate)
    _close(torch.cat(ttws, dim=-1), np.concatenate(jtws, axis=-1),
           STATE_TOL, "TW")
    np.testing.assert_allclose(tlls, jlls, rtol=LL_RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_gem_online_is_the_block_loop(case):
    """run_gem_online is a loop of online_block: the same bits."""
    X, A0, FB0, TW0, sigma, nb = _problem(case, seed=2)
    Nb = TW0.shape[-1]
    A, FB, TW, lls = online.run_gem_online(_t(A0), _t(FB0), _t(TW0), _t(X),
                                           _t(sigma), n_blocks=nb)
    state = online.online_init(_t(A0), _t(FB0))
    tws, ll_loop = [], []
    for b in range(nb):
        state, (TWb, ll) = online.online_block(
            state, _t(X[:, b * Nb:(b + 1) * Nb]), _t(TW0), _t(sigma))
        tws.append(TWb)
        ll_loop.append(ll)
    assert TW.shape == (1, 2, FB0.shape[-1], nb * Nb)
    assert lls.shape == (1, nb)
    assert torch.equal(A, state.A) and torch.equal(FB, state.FB)
    assert torch.equal(TW, torch.cat(tws, dim=-1))
    assert torch.equal(lls, torch.stack(ll_loop, dim=-1))


def test_run_gem_online_matches_jax_scan():
    """The whole-mixture entry against the JAX package's lax.scan."""
    X, A0, FB0, TW0, sigma, nb = _problem("rank1_I2", seed=3)
    jA, jFB, jTW, jll = jonline.run_gem_online(
        jnp.asarray(A0), jnp.asarray(FB0), jnp.asarray(TW0), jnp.asarray(X),
        jnp.asarray(sigma), n_blocks=nb, forgetting=0.9, inner_iters=4)
    tA, tFB, tTW, tll = online.run_gem_online(
        _t(A0), _t(FB0), _t(TW0), _t(X), _t(sigma), n_blocks=nb,
        forgetting=0.9, inner_iters=4)
    _close(tA[0], jA, STATE_TOL, "A")
    _close(tFB[0], jFB, STATE_TOL, "FB")
    _close(tTW[0], jTW, STATE_TOL, "TW")
    np.testing.assert_allclose(tll[0].numpy(), np.asarray(jll),
                               rtol=LL_RTOL)


@pytest.mark.parametrize("I", [2, 3])
def test_herm_sqrt_matches_jax(I):
    """The closed form (I = 2) and eigh (I = 3) square roots of ridge-
    loaded Hermitian PSD matrices: each squares back to R (rtol 1e-5 of
    the largest entry) and equals the JAX package's within 1e-5."""
    rng = np.random.default_rng(I)
    M = (rng.standard_normal((2, 5, I, I))
         + 1j * rng.standard_normal((2, 5, I, I))).astype(np.complex64)
    R = M @ np.conj(np.swapaxes(M, -1, -2)) + 1e-3 * np.eye(I)
    R = R.astype(np.complex64)
    got = online._herm_sqrt(torch.as_tensor(R)).numpy()
    want = np.asarray(jonline._herm_sqrt(jnp.asarray(R)))
    peak = np.max(np.abs(R))
    assert np.max(np.abs(got @ got - R)) <= 1e-5 * peak
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    np.testing.assert_allclose(got, np.conj(np.swapaxes(got, -1, -2)),
                               atol=1e-6 * peak)


def test_fullrank_needs_square_mixing():
    A0 = torch.ones((1, 2, 5, 3, 2), dtype=torch.complex64)
    FB0 = torch.ones((1, 2, 5, 4))
    with pytest.raises(ValueError, match="R == I"):
        online.online_init(A0, FB0)


def test_block_estep_takes_the_stereo_dispatch(monkeypatch):
    """An I = 2 block E-step goes through gem.estep_stereo (the kernels'
    dispatch on CUDA) with complex mixing; other I through the general
    engine."""
    calls = []
    real = gem.estep_stereo

    def spy(*args, **kw):
        calls.append(kw["real_cov"])
        return real(*args, **kw)

    monkeypatch.setattr(online, "estep_stereo", spy)
    for case, want in (("rank1_I2", [False] * 7), ("rank1_I3", [])):
        calls.clear()
        X, A0, FB0, TW0, sigma, _ = _problem(case, seed=4)
        Nb = TW0.shape[-1]
        online.online_block(online.online_init(_t(A0), _t(FB0)),
                            _t(X[:, :Nb]), _t(TW0), _t(sigma),
                            inner_iters=6)
        assert calls == want, case


def test_stereo_estep_has_no_fallback():
    """A device with no E-step path raises; nothing falls back to the
    CPU."""
    X = torch.zeros((1, 3, 4, 2), dtype=torch.complex64, device="meta")
    v = torch.zeros((1, 2, 3, 4), device="meta")
    A = tuple(torch.zeros((1, 3, 2, 1), dtype=torch.complex64,
                          device="meta") for _ in range(2))
    with pytest.raises(NotImplementedError, match="no E-step for device"):
        gem.estep_stereo(X, v, A, (1, 1), torch.zeros((1, 3),
                                                      device="meta"),
                         real_cov=False)
