"""pyfasst_tpu_torch.models.spatial_init against the JAX package's.

The counterparts of tests/test_spatial_init.py on the port, each also held
against the JAX package on the same numpy-seeded inputs:

- the host core (features, assignments, NumPy-backend clustering and
  votes, repairs, candidate families, mixing from votes) is the same NumPy
  code: equal bit for bit;
- the port's device backend (batched k-means in PyTorch) against the JAX
  package's backend="jax", as the JAX suite holds its two backends:
  argmax agreement above 0.99 and votes within 1e-6;
- the float32 statistics (envelope correlation, band coherence) within
  1e-5; the Lanczos embedding against eigh to sign (|cos| > 0.999);
- probe selection picks the same candidate when both packages start from
  the same spectral draws (the JAX package's, injected).
"""
import numpy as np
import pytest
import torch

from pyfasst_tpu.models import spatial_init as jsi
from pyfasst_tpu_torch.models import spatial_init as tsi
from test_spatial_init import (
    _repair_fixture, _three_channel_stft, _two_source_stft,
)

torch.set_num_threads(1)


def jax_draws(monkeypatch):
    """Make the port's EM-seed draws the JAX package's own (jax.random
    split of PRNGKey(seed), init_nmf_comp per source), converted."""
    import jax

    from pyfasst_tpu.models.components import init_nmf_comp
    from pyfasst_tpu_torch.models.components import SpectralComp

    def draws(seed, J, F, N, nmf_comps, dtype=torch.float32, device="cpu"):
        keys = list(jax.random.split(jax.random.PRNGKey(seed), J))
        out = []
        for j in range(J):
            c = init_nmf_comp(keys[j], F, N, nmf_comps, spat_ind=j)
            out.append(SpectralComp(
                FB=torch.tensor(np.asarray(c.FB), dtype=dtype)[None],
                TW=torch.tensor(np.asarray(c.TW), dtype=dtype)[None],
                spat_ind=j))
        return tuple(out)

    monkeypatch.setattr(tsi, "_em_seed_spec", draws)


def test_best_assignment_matches_hungarian():
    rng = np.random.default_rng(3)
    S = rng.standard_normal((17, 4, 4))
    sel = tsi._best_assignment(S)
    np.testing.assert_array_equal(sel, jsi._best_assignment(S))
    from scipy.optimize import linear_sum_assignment
    for f in range(S.shape[0]):
        rows, cols = linear_sum_assignment(-S[f])
        ref = np.empty(4, np.int64)
        ref[cols] = rows
        assert S[f][sel[f], np.arange(4)].sum() == pytest.approx(
            S[f][ref, np.arange(4)].sum())
    # J > 6 takes the Hungarian path in both packages
    S7 = rng.standard_normal((3, 7, 7))
    np.testing.assert_array_equal(tsi._best_assignment(S7),
                                  jsi._best_assignment(S7))


@pytest.mark.parametrize("I", [2, 3])
def test_covariance_features_bit_for_bit(I):
    rng = np.random.default_rng(I)
    X = rng.standard_normal((9, 11, I)) + 1j * rng.standard_normal((9, 11, I))
    for got, want in zip(tsi.tf_covariance_features(X),
                         jsi.tf_covariance_features(X)):
        np.testing.assert_array_equal(got, want)


def test_votes_recover_dominance():
    X, dom = _two_source_stft()
    votes = tsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, device="cpu")
    lab = votes.argmax(-1)
    pw = (np.abs(X) ** 2).sum(-1)
    loud = pw > np.quantile(pw, 0.5)
    acc = max((lab == dom)[loud].mean(), (lab == 1 - dom)[loud].mean())
    assert acc > 0.8, f"dominance recovery {acc:.2f}"


def test_numpy_backend_votes_bit_for_bit():
    X, _ = _two_source_stft(seed=5, reverb=True)
    got = tsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, backend="numpy")
    want = jsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, backend="numpy")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("align", ["spectral", "none", "activity"])
def test_device_backend_matches_jax_backend(align):
    """The port's batched k-means (backend 'device', on the CPU here)
    against the JAX package's backend 'jax': argmax agreement > 0.99 and
    votes within 1e-6 (the JAX suite's bar between its two backends)."""
    X, _ = _two_source_stft(seed=5, reverb=True)
    got = tsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, align=align,
                              device="cpu")
    want = jsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, align=align,
                               backend="jax")
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.99
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_device_and_numpy_backends_agree():
    X, _ = _two_source_stft(seed=5, reverb=True)
    vd = tsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, backend="device",
                             device="cpu")
    vn = tsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, backend="numpy")
    assert (vd.argmax(-1) == vn.argmax(-1)).mean() > 0.99
    np.testing.assert_allclose(vd, vn, atol=1e-6)


def test_device_labels_match_jax_labels():
    X, _ = _two_source_stft(seed=6, reverb=True)
    feat, w, _, _ = tsi.tf_covariance_features(X)
    got = tsi._cluster_labels_device(feat, w, 2, 4, 10, device="cpu")
    want = jsi._cluster_labels_jax(feat, w, 2, 4, 10)
    assert got.shape == want.shape == (4,) + X.shape[:2]
    assert (got == want).mean() > 0.99


def test_mixing_recovers_directions():
    X, _ = _two_source_stft(seed=1)
    feat, w, pw, xx = tsi.tf_covariance_features(X)
    votes = tsi.consensus_votes(X, J=2, n_seeds=3, kiter=10, device="cpu")
    A = tsi.mixing_from_votes(votes, xx, pw, rank=2)
    np.testing.assert_allclose(A, jsi.mixing_from_votes(votes, xx, pw, 2),
                               atol=1e-6)
    true_dirs = np.array([[1.0, 0.25], [0.3, 1.0]], complex)
    true_dirs /= np.linalg.norm(true_dirs, axis=1, keepdims=True)
    prin = A[:, :, :, 0]
    prin = prin / np.maximum(np.linalg.norm(prin, axis=-1, keepdims=True),
                             1e-12)
    cos = np.abs(np.einsum('jfi,ki->jfk', prin, true_dirs.conj())).mean(1)
    best = max(min(cos[0, 0], cos[1, 1]), min(cos[0, 1], cos[1, 0]))
    assert best > 0.9, f"direction recovery |cos| {best:.3f}"


def test_full_rank_init_shapes_profiles():
    X, _ = _two_source_stft(seed=2, reverb=True)
    F, N = X.shape[:2]
    A, tw, fb = tsi.full_rank_init(X, J=2, n_seeds=2, kiter=8, device="cpu")
    assert A.shape == (2, F, 2, 2)
    assert tw.shape == (2, N) and fb.shape == (2, F)
    assert np.all(tw >= 0.3 - 1e-9) and np.all(tw <= 1.0 + 1e-9)
    assert np.all(fb >= 0.3 - 1e-9) and np.all(fb <= 1.0 + 1e-9)
    assert np.all(np.isfinite(A))
    R = np.einsum('jfir,jfkr->jfik', A, A.conj())
    np.testing.assert_allclose(np.trace(R, axis1=2, axis2=3).real, 2.0,
                               rtol=1e-5)


def test_full_rank_init_heuristic_repair_bit_for_bit():
    """repair=True runs no probe: the NumPy backend's whole init is the
    JAX package's bits."""
    X, _ = _two_source_stft(seed=2, reverb=True)
    got = tsi.full_rank_init(X, J=2, n_seeds=2, kiter=8, backend="numpy",
                             repair=True)
    want = jsi.full_rank_init(X, J=2, n_seeds=2, kiter=8, backend="numpy",
                              repair=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_repair_votes_fixes_merge_and_split():
    votes, pw, dom = _repair_fixture()
    rep = tsi.repair_votes(votes, pw)
    np.testing.assert_array_equal(rep, jsi.repair_votes(votes, pw))
    lab = rep.argmax(-1)
    src0 = dom == 0
    assert max((lab[src0] == c).mean() for c in range(3)) > 0.95
    from collections import Counter
    cb = Counter(lab[dom == 1].ravel()).most_common(1)[0][0]
    cc = Counter(lab[dom == 2].ravel()).most_common(1)[0][0]
    assert cb != cc
    assert (lab[dom == 1] == cb).mean() > 0.8
    assert (lab[dom == 2] == cc).mean() > 0.8


def test_repair_votes_no_false_positive():
    rng = np.random.default_rng(1)
    F, N = 48, 90
    e = np.stack([1 + 0.9 * np.sin(2 * np.pi * np.arange(N) / p)
                  for p in (13.0, 29.0, 47.0)])
    P = rng.random((3, F, 1)) * e[:, None, :] + 1e-6
    votes = np.eye(3)[P.argmax(0)]
    np.testing.assert_array_equal(tsi.repair_votes(votes, P.sum(0)), votes)


def test_candidate_votes_match_jax():
    votes, pw, _ = _repair_fixture()
    got = tsi.candidate_votes(votes, pw)
    want = jsi.candidate_votes(votes, pw)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert got[0][0] == "raw" and len(got) > 1
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_allclose(g.sum(-1), votes.sum(-1), atol=1e-9)


def test_direction_split_candidates_match_jax():
    """J = 3 over the NumPy backend: D = 2 direction groups, every
    allocation and NMF split seed, names and arrays equal."""
    X, _ = _two_source_stft(F=32, N=48, seed=4, reverb=True)
    pw = tsi.tf_covariance_features(X)[2]
    got = tsi.direction_split_candidates(X, 3, pw, n_seeds=2, kiter=6,
                                         backend="numpy")
    want = jsi.direction_split_candidates(X, 3, pw, n_seeds=2, kiter=6,
                                          backend="numpy")
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [n for n, _ in got][0] == "dirs2+alloc(1, 2)#s0"
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_realign_and_activity_profiles_match_jax():
    X, _ = _two_source_stft(F=40, N=60, seed=8, reverb=True)
    pw = tsi.tf_covariance_features(X)[2]
    votes = tsi.consensus_votes(X, 2, n_seeds=2, kiter=6, backend="numpy")
    np.testing.assert_array_equal(tsi.realign_votes(votes, pw, 2),
                                  jsi.realign_votes(votes, pw, 2))
    for g, w in zip(tsi.activity_profiles(votes, pw),
                    jsi.activity_profiles(votes, pw)):
        np.testing.assert_array_equal(g, w)


def test_init_plugs_into_engine():
    from pyfasst_tpu_torch.models.variants import MultiChanNMFConv
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((4000, 2)).astype(np.float32) * 0.1
    model = MultiChanNMFConv(mix, fs=8000, nbComps=2, nbNMFComps=3,
                             spatial_rank=2, wlen=256, iter_num=12,
                             spatial_hold_frac=0.3, device="cpu")
    A, tw, fb = tsi.full_rank_init(model.Xs[0].numpy(), J=2, n_seeds=2,
                                   kiter=5, device="cpu")
    model2 = MultiChanNMFConv(mix, fs=8000, nbComps=2, nbNMFComps=3,
                              spatial_rank=2, init_mixing=A, wlen=256,
                              iter_num=12, spatial_hold_frac=0.3,
                              device="cpu")
    model2.params = tsi.apply_profiles(model2.params, tw, fb)
    assert np.all(np.isfinite(model2.estim_param_a_posteriori()))
    assert np.all(np.isfinite(model2.separated_images()))


def test_apply_profiles_matches_jax():
    from pyfasst_tpu.models.components import (
        FasstParams as JP, SpatialComp as JS, SpectralComp as JC,
    )
    from torch_parity import to_torch_params
    rng = np.random.default_rng(2)
    F, N, K = 7, 9, 3
    spec = tuple(JC(FB=(0.5 + rng.random((F, K))).astype(np.float32),
                    TW=(0.5 + rng.random((K, N))).astype(np.float32),
                    spat_ind=j) for j in range(2))
    spat = tuple(JS(A=np.ones((2, 1), np.float32)) for _ in range(2))
    jp = JP(spat=spat, spec=spec)
    tw, fb = 0.3 + rng.random((2, N)), 0.3 + rng.random((2, F))
    want = jsi.apply_profiles(jp, tw, fb)
    got = tsi.apply_profiles(to_torch_params(jp), tw, fb)
    for g, w in zip(got.spec, want.spec):
        np.testing.assert_array_equal(g.TW[0].numpy(), np.asarray(w.TW))
        np.testing.assert_array_equal(g.FB[0].numpy(), np.asarray(w.FB))


def test_select_init_by_likelihood_matches_jax(monkeypatch):
    """From the JAX package's probe draws, the port's batched probes pick
    the same hypothesis."""
    jax_draws(monkeypatch)
    X, _ = _two_source_stft(F=64, N=96, seed=2, reverb=True)
    _, _, pw, xx = tsi.tf_covariance_features(X)
    votes = tsi.consensus_votes(X, 2, n_seeds=2, kiter=8, backend="numpy")
    cands = tsi.candidate_votes(votes, pw)
    A, twp, fbp, name = tsi.select_init_by_likelihood(
        X, cands, xx, pw, rank=2, probe_iters=8, nmf_comps=3, device="cpu")
    assert A.shape == (2, 64, 2, 2)
    assert twp.shape == (2, 96) and fbp.shape == (2, 64)
    *_, want = jsi.select_init_by_likelihood(X, cands, xx, pw, rank=2,
                                             probe_iters=8, nmf_comps=3)
    assert name == want


def test_select_warns_when_all_hypotheses_degenerate():
    import warnings
    X, _ = _two_source_stft(F=64, N=96, seed=2, reverb=True)
    _, _, pw, xx = tsi.tf_covariance_features(X)
    votes = tsi.consensus_votes(X, 2, n_seeds=2, kiter=8, device="cpu")
    cands = tsi.candidate_votes(votes, pw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        A, *_ = tsi.select_init_by_likelihood(
            X, cands, xx, pw, rank=2, probe_iters=8, nmf_comps=3,
            env_thr=-1.0, device="cpu")
    assert any("duplicated" in str(r.message) for r in rec)
    assert A.shape == (2, 64, 2, 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        tsi.select_init_by_likelihood(X, cands, xx, pw, n_devices=2,
                                      device="cpu")


def _stems(rng, F=32, N=200):
    base = rng.random((F, N)) * (1 + np.sin(2 * np.pi * np.arange(N)
                                            / 23.0))[None]
    half = rng.random((F, N)) < 0.5
    mags = [np.sqrt(base * half), np.sqrt(base * ~half),
            np.sqrt(rng.random((F, N)) * (1 + np.cos(
                2 * np.pi * np.arange(N) / 7.0))[None])]
    dup = np.stack([np.stack([m, m], -1) for m in mags]).astype(np.complex64)
    mags = [np.sqrt(rng.random((F, N)) * (1 + np.sin(
        2 * np.pi * np.arange(N) / p))[None]) for p in (11.0, 29.0, 53.0)]
    distinct = np.stack([np.stack([m, 0.7 * m], -1)
                         for m in mags]).astype(np.complex64)
    return dup, distinct


def test_max_env_corr_flags_duplicated_source_and_matches_jax(rng):
    dup, distinct = _stems(rng)
    got = tsi._max_env_corr(torch.as_tensor(np.stack([dup, distinct])))
    assert float(got[0]) > 0.8 and float(got[1]) < 0.5
    for g, Y in zip(got, (dup, distinct)):
        assert float(g) == pytest.approx(float(jsi._max_env_corr(Y)),
                                         abs=1e-5)


def test_band_coherence_matches_jax(rng):
    dup, distinct = _stems(rng, F=64)
    Yb = torch.as_tensor(np.stack([dup, distinct]))
    coh, pr = tsi._band_coherence_stats(Yb)
    mins = tsi._min_band_coherence(Yb)
    for i, Y in enumerate((dup, distinct)):
        jc, jp = jsi._band_coherence_stats(Y)
        np.testing.assert_allclose(coh[i].numpy(), np.asarray(jc),
                                   atol=1e-5)
        np.testing.assert_allclose(pr[i].numpy(), np.asarray(jp),
                                   rtol=1e-5)
        assert float(mins[i]) == pytest.approx(
            float(jsi._min_band_coherence(Y)), abs=1e-5)


def test_covariance_features_i3_embed_stereo():
    X2, _ = _two_source_stft(F=32, N=40, seed=3, reverb=True)
    X3 = np.concatenate([X2, np.zeros(X2.shape[:2] + (1,), complex)], -1)
    f2, w2, pw2, xx2 = tsi.tf_covariance_features(X2)
    f3, w3, pw3, xx3 = tsi.tf_covariance_features(X3)
    assert f3.shape == X2.shape[:2] + (9,)
    np.testing.assert_allclose(pw3, pw2, rtol=1e-12)
    np.testing.assert_allclose(f3[..., [0, 1, 3, 4]], f2, rtol=1e-6)
    np.testing.assert_allclose(f3[..., [2, 5, 6, 7, 8]], 0.0, atol=1e-15)
    np.testing.assert_allclose(xx3[..., :2, :2], xx2, rtol=1e-12)


def test_votes_and_mixing_i3():
    X, dom, a = _three_channel_stft(seed=1)
    votes = tsi.consensus_votes(X, J=2, n_seeds=3, kiter=10,
                                backend="numpy")
    np.testing.assert_array_equal(
        votes, jsi.consensus_votes(X, J=2, n_seeds=3, kiter=10,
                                   backend="numpy"))
    lab = votes.argmax(-1)
    pw = (np.abs(X) ** 2).sum(-1)
    loud = pw > np.quantile(pw, 0.5)
    assert max((lab == dom)[loud].mean(), (lab == 1 - dom)[loud].mean()) \
        > 0.8
    _, _, pw, xx = tsi.tf_covariance_features(X)
    A = tsi.mixing_from_votes(votes, xx, pw, rank=3)
    assert A.shape == (2, X.shape[0], 3, 3)
    prin = A[:, :, :, 0]
    prin = prin / np.linalg.norm(prin, axis=-1, keepdims=True)
    ref = a / np.linalg.norm(a, axis=-1, keepdims=True)
    cos = np.abs(np.einsum('jfi,kfi->jfk', prin, ref.conj())).mean(1)
    assert max(min(cos[0, 0], cos[1, 1]), min(cos[0, 1], cos[1, 0])) > 0.9


def test_lanczos_top_matches_eigh(rng):
    n, k = 300, 3
    A = rng.standard_normal((n, n)).astype(np.float32)
    M = (A @ A.T) / n
    U = tsi._lanczos_top(torch.as_tensor(M), k).numpy()
    _, vecs = np.linalg.eigh(M.astype(np.float64))
    for j in range(k):
        dot = abs(float(U[:, j] @ vecs[:, -k + j]))
        assert dot / float(np.linalg.norm(U[:, j])) > 0.999, j


def test_embed_nodes_device_matches_host(rng):
    """The device graph build + Lanczos (on the CPU here) undoes planted
    per-frequency permutations as the host path does, and spans the same
    subspace as the JAX package's device path."""
    F, J, N = 60, 3, 80
    base = np.stack([1.0 + 0.9 * np.sin(2 * np.pi * np.arange(N) / p)
                     for p in (7.0, 13.0, 29.0)])
    perms = np.stack([rng.permutation(J) for _ in range(F)])
    act = base[perms] * rng.uniform(0.5, 2.0, (F, 1, 1))
    act += 0.05 * rng.uniform(size=act.shape)
    U_host, npow = tsi._embed_nodes(act, None)
    np.testing.assert_array_equal(U_host, jsi._embed_nodes(act, None)[0])
    U_dev = tsi._embed_nodes_device(act, device="cpu")
    for U in (U_host, U_dev):
        cent = tsi._spherical_kmeans(U, npow, J, seed=0)
        sel = tsi._assignment_from_embedding(U, cent, F, J)
        comp = np.take_along_axis(perms, sel, axis=1)
        assert (comp == comp[0]).all(), comp[:5]
    U_jax = np.asarray(jsi._embed_nodes_device(act), np.float64)
    # same column space: the projection of one basis onto the other
    Q1, _ = np.linalg.qr(U_dev.astype(np.float64))
    Q2, _ = np.linalg.qr(U_jax)
    assert np.linalg.svd(Q1.T @ Q2, compute_uv=False).min() > 0.999


def test_env_transform_rank_alignment():
    rng = np.random.default_rng(7)
    F, J, N = 30, 2, 64
    gate = np.sin(2 * np.pi * 3.0 * np.arange(N) / N)
    base = np.stack([gate > 0, gate < 0], 0).astype(float)
    pw = np.ones((F, N))
    olab = np.repeat(np.argmax(base, 0)[None, :], F, 0)
    perms = np.stack([rng.permutation(J) for _ in range(F)])
    lab = np.take_along_axis(perms, olab, axis=1)
    for tr in ("log1p", "rank"):
        La = tsi._align_spectral(lab, pw, J, env_transform=tr)
        np.testing.assert_array_equal(
            La, jsi._align_spectral(lab, pw, J, env_transform=tr))
        agree = (La == olab).mean()
        assert max(agree, 1 - agree) > 0.95, (tr, agree)
    with pytest.raises(ValueError):
        tsi._env_envelope(np.ones((2, 2, 4)), "bogus")


def test_band_em_votes_rejects_an_unknown_alignment():
    X, _ = _two_source_stft(F=8, N=10, seed=1)
    feat, w, pw, xx = tsi.tf_covariance_features(X)
    probes = tsi.BandProbes(
        starts=(0,), Fb=8, pick=np.zeros(1, np.int64),
        lab=np.zeros((1, 8, 10), np.int64), env=np.ones((1, 2, 10)),
        ll=np.zeros(1), names=((0, 0),), votes_init=np.full((8, 10, 2), .5),
        feat=feat, w=w, pw=pw, xx=xx)
    with pytest.raises(ValueError, match="band_align"):
        tsi.band_em_votes(X, 2, band_align="bogus", probes=probes)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        tsi.band_em_votes(X, 2, n_devices=2, device="cpu")
