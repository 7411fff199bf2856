"""pyfasst_tpu_torch.models.reverb against the JAX package's.

The blind pipeline's decisions come from argmax, argmin and rounded
statistics, so parity compares decisions: the same selection keys, the
same picked run and the same stage history. The parity runs hand the port
the JAX package's own EM-seed draws (spatial_init._em_seed_spec replaced),
which the port's own draws now equal bit for bit
(tests/test_torch_prng.py). Images: within 5e-4 of their peak
(float32 GEM in two packages, 40 iterations; tests/test_torch_conv.py's
conv runs agree to ~1e-4). Everything here runs on the CPU, at
tests/test_reverb_pipeline.py's sizes (J = 2, F = 65, N = 96, chunk 4).
"""
import numpy as np
import pytest
import torch

import pyfasst_tpu_torch
from pyfasst_tpu.models import reverb as jrv
from pyfasst_tpu_torch.models import reverb as trv
from pyfasst_tpu_torch.models import spatial_init as tsi
from test_reverb_pipeline import _reverb_mixture, _time_mixture
from test_torch_spatial_init import jax_draws

torch.set_num_threads(1)

SMALL = dict(iters=30, em_seeds=1, reseed_rounds=1, nmf_comps=3, chunk=4,
             n_seeds=3)

_RECORDS = [
    {"name": "raw", "envcorr": 0.3, "min_share": 0.2, "final_ll": 10.0},
    {"name": "merge(0,1)+split(0)", "envcorr": 0.2, "min_share": 0.2,
     "final_ll": 5.0, "consistency": 0.7, "learned": 0.8},
    {"name": "raw", "envcorr": 0.9, "min_share": 0.2, "final_ll": 100.0,
     "consistency": 0.99},
    {"name": "raw", "envcorr": 0.1, "min_share": 0.001, "final_ll": 100.0},
    {"name": "raw", "envcorr": 0.3, "min_share": 0.2, "final_ll": 20.0,
     "learned": 0.9},
    {"name": "dirs3+alloc(2, 1, 1)#s0", "envcorr": 0.01, "min_share": 0.1,
     "final_ll": 100.0, "consistency": 0.999},
    {"name": "whatever", "tier": 1, "envcorr": 0.01, "min_share": 0.1,
     "final_ll": 100.0},
    {"name": "bandem", "envcorr": 0.3, "min_share": 0.2, "final_ll": 5.0,
     "consistency": 0.95},
]


@pytest.mark.parametrize("select", ["envcorr", "consistency", "learned"])
def test_selection_key_matches_jax(select):
    for rec in _RECORDS:
        assert trv.selection_key(rec, select=select) == \
            jrv.selection_key(rec, select=select), rec
    key = lambda r: trv.selection_key(r, select=select)
    assert sorted(_RECORDS, key=key) == sorted(
        _RECORDS, key=lambda r: jrv.selection_key(r, select=select))


def test_selection_key_order():
    healthy, healthier, dup, vanished = _RECORDS[:4]
    order = sorted([dup, vanished, healthy, healthier],
                   key=trv.selection_key)
    assert order[0] is healthier and order[1] is healthy
    assert trv.selection_key(dup)[0] and trv.selection_key(vanished)[0]
    decoy = _RECORDS[5]
    assert trv.selection_key(healthy) < trv.selection_key(decoy) \
        < trv.selection_key(dup)
    assert trv.selection_key(_RECORDS[6])[1] == 1


def test_hard_votes_from_sep_match_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((3, 5, 7, 2)) + 1j * rng.standard_normal(
        (3, 5, 7, 2))
    votes = trv._hard_votes_from_sep(torch.as_tensor(Y), 3)
    np.testing.assert_array_equal(
        votes, jrv._hard_votes_from_sep(jnp.asarray(Y), 3))
    assert votes.shape == (5, 7, 3)
    np.testing.assert_array_equal(votes.sum(-1), np.ones((5, 7)))


def _same_run(info_t, info_j, Yt, Yj, bar=5e-4):
    assert info_t["picked"] == info_j["picked"]
    assert [h["picked"] for h in info_t["history"]] == \
        [h["picked"] for h in info_j["history"]]
    assert info_t["history"][0]["pool"] == info_j["history"][0]["pool"]
    assert info_t["envcorr"] == pytest.approx(info_j["envcorr"], abs=2e-4)
    assert Yt.shape == Yj.shape
    err = np.abs(Yt - Yj).max() / np.abs(Yj).max()
    assert err < bar, err


def test_blind_reverb_separate_matches_jax(monkeypatch):
    """Two EM seeds, one reseed round: from the JAX package's draws the
    port runs the same pool (22 runs in chunks of 4), picks the same run
    at every stage and returns the same images."""
    jax_draws(monkeypatch)
    X = _reverb_mixture()
    kw = dict(SMALL, iters=40, em_seeds=2)
    Yj, ij = jrv.blind_reverb_separate(X, J=2, **kw)
    Yt, it = trv.blind_reverb_separate(X, J=2, device="cpu", **kw)
    _same_run(it, ij, Yt, Yj)
    assert it["select"] == ij["select"] == "envcorr"
    assert -1.0 <= it["envcorr"] <= 1.0 and 0.0 <= it["min_share"] <= 0.5
    p = it["params"]
    assert p.batch == 1 and p.spat[0].A.shape == (1, 65, 2, 2)
    assert set(it["stage_seconds"]) == {"votes", "pool", "reseeds"}


def test_learned_candidate_and_judge_match_jax(monkeypatch):
    """learned=True with select='learned', a tiny untrained net in both
    packages (the same numpy init): the learned candidate enters the pool
    and the judge orders it the same way."""
    from pyfasst_tpu.models.binfeat import init_params as jinit
    from pyfasst_tpu_torch.models.binfeat import init_params as tinit
    jax_draws(monkeypatch)
    tiny = dict(seed=0, c_in=5, width=8, emb_dim=4,
                layers=((3, 3, 1, 1), (3, 3, 2, 2)))
    X = _reverb_mixture(seed=5)
    kw = dict(SMALL, reseed_rounds=0, learned=True, select="learned")
    Yj, ij = jrv.blind_reverb_separate(X, J=2, learned_params=jinit(**tiny),
                                       **kw)
    Yt, it = trv.blind_reverb_separate(X, J=2, learned_params=tinit(**tiny),
                                       device="cpu", **kw)
    _same_run(it, ij, Yt, Yj)
    assert it["select"] == "learned"
    assert it["history"][0]["pool"] == ij["history"][0]["pool"]
    assert "learned" in it["stage_seconds"]


def test_blind_reverb_end_to_end_contract():
    X = _reverb_mixture()
    Y, info = trv.blind_reverb_separate(X, J=2, device="cpu", **SMALL)
    assert Y.shape == (2,) + X.shape
    assert np.all(np.isfinite(Y.view(np.float32)))
    assert len(info["history"]) >= 1
    pm, ps = float(np.sum(np.abs(X) ** 2)), float(np.sum(np.abs(Y) ** 2))
    assert 0.2 * pm < ps < 3.0 * pm


def test_consistency_select_and_guarded_reseeds():
    X = _reverb_mixture(seed=9)
    Y, info = trv.blind_reverb_separate(
        X, J=2, device="cpu", **dict(SMALL, em_seeds=2, reseed_rounds=2),
        select="consistency", reseed_select="envcorr", keep_pool_sep=True)
    assert "consistency" in info and -1.0 <= info["consistency"] <= 1.0
    assert info["pool_picked"] == info["history"][0]["picked"]
    assert info["pool_Y"].shape == Y.shape
    reseeds = [h for h in info["history"] if h["stage"].startswith("reseed")]
    assert reseeds and all("accepted" in h for h in reseeds)
    if not any(h["accepted"] for h in reseeds):
        assert info["picked"] == info["pool_picked"]
        np.testing.assert_array_equal(Y, info["pool_Y"])


def test_select_auto_resolution_and_pool_options():
    X = _reverb_mixture(seed=3)
    _, base = trv.blind_reverb_separate(
        X, J=2, device="cpu", **dict(SMALL, reseed_rounds=0))
    assert base["select"] == "envcorr"
    _, more = trv.blind_reverb_separate(
        X, J=2, device="cpu", **dict(SMALL, reseed_rounds=0),
        noalign=True, env_transform="both")
    # noalign adds one candidate; 'both' a second raw/merge/realign family
    assert more["history"][0]["pool"] > base["history"][0]["pool"] + 1


def test_rank_transform_and_realigned_reseeds():
    X = _reverb_mixture(seed=3)
    Y, info = trv.blind_reverb_separate(
        X, J=2, device="cpu", **SMALL, env_transform="rank",
        realign_reseeds=True)
    assert np.all(np.isfinite(Y.view(np.float32)))
    assert tsi._ENV_TRANSFORM == "log1p"


def test_topk_keeps_distinct_candidates():
    X = _reverb_mixture(seed=2)
    _, info = trv.blind_reverb_separate(
        X, J=2, device="cpu", **dict(SMALL, em_seeds=2, reseed_rounds=0),
        topk=2)
    tops = info["tops"]
    assert len(tops) == 2
    assert len({t["name"].split("|")[0] for t in tops}) == 2
    assert tops[0]["Y"].shape == (2,) + X.shape[:2] + (2,)


def test_blind_reverb_on_warped_plane():
    from pyfasst_tpu_torch.tf.erblet import ERBLetTransform
    rng = np.random.default_rng(3)
    fs, n = 4000, 4096
    t = np.arange(n) / fs
    gate1 = ((np.arange(n) // 600) % 2 == 0).astype(float)
    s1 = np.sin(2 * np.pi * 150.0 * t) * gate1
    s2 = rng.standard_normal(n) * (1.0 - 0.9 * gate1)
    s2 -= np.convolve(s2, np.ones(9) / 9.0, "same")
    mix = np.outer(s1, [1.0, 0.25]) + np.outer(s2, [0.3, 1.0])
    tft = ERBLetTransform(fs=fs, n_bands=12, fmin=40.0, device="cpu")
    X = tft.computeTransform(mix.astype(np.float32)).numpy()
    Y, info = trv.blind_reverb_separate(
        X, J=2, device="cpu", **dict(SMALL, iters=25, reseed_rounds=0))
    assert Y.shape == (2,) + X.shape and info["picked"]
    y0 = tft.invertTransform(torch.as_tensor(Y[0]), nsamples=n)
    assert tuple(y0.shape) == (n, 2) and bool(torch.isfinite(y0).all())


def test_blind_reverb_i3_smoke():
    from test_spatial_init import _three_channel_stft
    X, _, _ = _three_channel_stft(F=48, N=64, seed=2)
    Y, info = trv.blind_reverb_separate(X, J=2, iters=8, em_seeds=1,
                                        reseed_rounds=1, nmf_comps=3,
                                        rank=3, chunk=4, device="cpu")
    assert Y.shape == (2, 48, 64, 3)
    assert np.isfinite(info["final_ll"])
    rel = np.abs(Y.sum(0) - X).mean() / np.abs(X).mean()
    assert rel < 0.35, rel


def test_host_api_estim_param_blind_reverb():
    """The model entry point installs the winner (B = 1) at Xs' scale:
    separated_images, WAVs and checkpoints work as after
    estim_param_a_posteriori."""
    mix, _ = _time_mixture(seed=1)
    m = pyfasst_tpu_torch.MultiChanNMFConv(
        mix, fs=4000, wlen=256, iter_num=20, nbComps=2, nbNMFComps=3,
        spatial_rank=2, device="cpu")
    info = m.estim_param_blind_reverb(reseed_rounds=1, em_seeds=1, chunk=4,
                                      n_seeds=3)
    assert info["picked"] and m.params.batch == 1
    assert m.params.spec[0].TW.shape == (1, 3, m.N)
    ys = m.separated_images()
    assert ys.shape == (2, mix.shape[0], 2) and np.all(np.isfinite(ys))
    # Wiener conservation at the model's scale
    assert np.abs(ys.sum(0) - mix).max() < 0.05 * np.abs(mix).max()


def test_full_rank_init_feeds_the_host_api():
    mix, _ = _time_mixture(seed=2)
    m = pyfasst_tpu_torch.MultiChanNMFConv(
        mix, fs=4000, wlen=256, iter_num=10, nbComps=2, nbNMFComps=3,
        spatial_rank=2, device="cpu")
    A, tw, fb = tsi.full_rank_init(m.Xs[0].numpy(), 2, n_seeds=2, kiter=5,
                                   probe_iters=5, device="cpu")
    m2 = pyfasst_tpu_torch.MultiChanNMFConv(
        mix, fs=4000, wlen=256, iter_num=10, nbComps=2, nbNMFComps=3,
        spatial_rank=2, init_mixing=A, device="cpu")
    m2.params = tsi.apply_profiles(m2.params, tw, fb)
    assert np.all(np.isfinite(m2.estim_param_a_posteriori()))


def test_multi_device_pool_raises():
    """Without a torch.distributed group every entry point that takes
    n_devices refuses more than one, saying how to launch (the pools on a
    mesh: tests/test_torch_sharding.py)."""
    X = _reverb_mixture()
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        trv.blind_reverb_separate(X, J=2, n_devices=2, device="cpu")
    mix, _ = _time_mixture()
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        trv.blind_reverb_separate_multiscale(mix, J=2, fs=4000,
                                             n_devices=2, device="cpu")
