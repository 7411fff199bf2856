"""pyfasst_tpu_torch.models.binfeat against the JAX package's.

Same numpy-seeded inputs through both packages. Bars: bin_inputs and the
weights bit for bit (the same NumPy code and file); embed within 1e-4 of
the JAX package's embed_host with the shipped weights (float32 convs in
another summation order, TF32 off on both sides) and 1e-5 with a tiny
random net; learned_votes agreeing on at least 99% of the power-weighted
bins; dc_loss within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

from pyfasst_tpu.models import binfeat as jbf
from pyfasst_tpu_torch.models import binfeat as tbf
from test_reverb_pipeline import _reverb_mixture

torch.set_num_threads(1)

TINY = dict(seed=0, c_in=5, width=8, emb_dim=4,
            layers=((3, 3, 1, 1), (3, 3, 2, 2)))


def _plane(seed, F=33, N=20):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((F, N, 2)) + 1j * rng.standard_normal((F, N,
                                                                      2))


def test_bin_inputs_bit_for_bit_and_scale_invariant():
    X = _plane(0)
    inp, pw = tbf.bin_inputs(X)
    jinp, jpw = jbf.bin_inputs(X)
    np.testing.assert_array_equal(inp, jinp)
    np.testing.assert_array_equal(pw, jpw)
    assert inp.shape == (33, 20, 5) and pw.shape == (33, 20)
    inp2, _ = tbf.bin_inputs(X * 7.3)
    np.testing.assert_allclose(inp2[..., :4], inp[..., :4], atol=1e-5)
    np.testing.assert_allclose(inp2[..., 4], inp[..., 4], atol=1e-3)


def test_shipped_weights_are_the_jax_packages_file():
    """The port's copy equals pyfasst_tpu/data/binfeat.npz array by array
    (read with numpy), and loads in OIHW."""
    mine = np.load(tbf.default_params_path())
    ref = np.load(jbf.default_params_path())
    assert sorted(mine.files) == sorted(ref.files)
    assert len([k for k in ref.files if k != "_meta_json"]) == 17
    for k in ref.files:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    assert tbf.has_default_params()
    p = tbf.load_params()
    for k in ref.files:
        if k.endswith("/w"):
            np.testing.assert_array_equal(p[k],
                                          np.transpose(ref[k], (3, 2, 0, 1)))


def test_init_params_match_jax_draws():
    got, want = tbf.init_params(**TINY), jbf.init_params(**TINY)
    assert got["_meta"] == want["_meta"]
    for k, v in want.items():
        if k == "_meta":
            continue
        w = np.transpose(v, (3, 2, 0, 1)) if k.endswith("/w") else v
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_embed_unit_norm_and_shape():
    rng = np.random.default_rng(1)
    inp = rng.standard_normal((2, 16, 12, 5)).astype(np.float32)
    w = tbf._as_tensors(tbf.init_params(**TINY), "cpu")
    V = tbf.embed(w, torch.as_tensor(inp)).numpy()
    assert V.shape == (2, 16, 12, 4)
    np.testing.assert_allclose(np.linalg.norm(V, axis=-1),
                               np.ones((2, 16, 12)), atol=1e-5)


def test_embed_tiny_net_matches_jax():
    rng = np.random.default_rng(2)
    inp = rng.standard_normal((2, 16, 12, 5)).astype(np.float32)
    p = tbf.init_params(**TINY)
    # give the biases and gains non-trivial values in both layouts
    jp = jbf.init_params(**TINY)
    for k in list(p):
        if k.endswith(("/b", "/g")):
            p[k] = jp[k] = (0.5 + rng.random(p[k].shape)).astype(np.float32)
    got = tbf.embed(tbf._as_tensors(p, "cpu"), torch.as_tensor(inp)).numpy()
    want = np.asarray(jbf.embed(jbf._as_pytree(jp), inp))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_embed_shipped_weights_match_jax_embed_host():
    X = _reverb_mixture(F=65, N=48, seed=4)
    inp, _ = tbf.bin_inputs(X)
    got = tbf.embed_host(tbf.load_params(), inp, device="cpu")
    want = jbf.embed_host(jbf.load_params(), inp)
    assert got.shape == want.shape == (65, 48, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_learned_votes_agree_with_jax():
    X = _reverb_mixture(seed=5)
    got = tbf.learned_votes(X, 2, device="cpu")
    want = jbf.learned_votes(X, 2)
    assert got.shape == (65, 96, 2)
    np.testing.assert_array_equal(got.sum(-1), 1.0)
    assert set(np.unique(got)) <= {0.0, 1.0}
    _, pw = tbf.bin_inputs(X)
    agree = float(((got.argmax(-1) == want.argmax(-1)) * pw).sum()
                  / pw.sum())
    assert agree >= 0.99, agree


def test_learned_votes_tiny_net_shape():
    X = _plane(4, F=33, N=24)
    votes, V = tbf.learned_votes(X, J=3, params=tbf.init_params(**TINY),
                                 n_seeds=2, device="cpu", return_emb=True)
    assert votes.shape == (33, 24, 3) and V.shape == (33, 24, 4)
    np.testing.assert_allclose(votes.sum(-1), np.ones((33, 24)))
    want = jbf.learned_votes(X, J=3, params=jbf.init_params(**TINY),
                             n_seeds=2)
    _, pw = tbf.bin_inputs(X)
    assert ((votes.argmax(-1) == want.argmax(-1)) * pw).sum() / pw.sum() \
        >= 0.99


def test_weighted_spherical_kmeans_bit_for_bit():
    rng = np.random.default_rng(6)
    V = rng.standard_normal((500, 4))
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    wb = rng.random(500)
    lab, score = tbf._weighted_spherical_kmeans(V, wb, 3, seed=1)
    jlab, jscore = jbf._weighted_spherical_kmeans(V, wb, 3, seed=1)
    np.testing.assert_array_equal(lab, jlab)
    assert score == jscore


def test_dc_loss_matches_jax_and_its_gradient_step_lowers_it():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 3, size=(2, 8, 10))
    Y = np.eye(4, dtype=np.float32)[lab]
    wb = np.full((2, 8, 10), 1.0 / 80, np.float32)
    V = rng.standard_normal((2, 8, 10, 4)).astype(np.float32)
    V /= np.linalg.norm(V, axis=-1, keepdims=True)
    got = float(tbf.dc_loss(torch.as_tensor(V), torch.as_tensor(Y),
                            torch.as_tensor(wb)))
    want = float(jbf.dc_loss(jnp.asarray(V), jnp.asarray(Y),
                             jnp.asarray(wb)))
    assert got == pytest.approx(want, rel=1e-5)
    assert abs(float(tbf.dc_loss(torch.as_tensor(Y), torch.as_tensor(Y),
                                 torch.as_tensor(wb)))) < 1e-5
    assert got > 0.1
    # training: the tiny net's loss falls under Adam on a separable toy
    w = tbf._as_tensors(tbf.init_params(**TINY), "cpu")
    meta = w.pop("_meta")
    for t in w.values():
        t.requires_grad_(True)
    lab = (rng.uniform(size=(2, 16, 12)) < 0.5).astype(np.int64)
    inp = rng.standard_normal((2, 16, 12, 5)).astype(np.float32) * 0.1
    inp[..., 0] += lab
    inp, Yt = torch.as_tensor(inp), torch.eye(4)[torch.as_tensor(lab)]
    wt = torch.full((2, 16, 12), 1.0 / (16 * 12))

    def loss():
        return tbf.dc_loss(tbf.embed({**w, "_meta": meta}, inp), Yt, wt)

    opt = torch.optim.Adam(list(w.values()), lr=3e-3)
    l0 = float(loss().detach())
    for _ in range(30):
        opt.zero_grad()
        loss().backward()
        opt.step()
    assert float(loss().detach()) < 0.8 * l0


def test_save_load_roundtrip_across_packages(tmp_path):
    p = tbf.init_params(**TINY)
    path = str(tmp_path / "w.npz")
    tbf.save_params(p, path)
    back = tbf.load_params(path)
    assert back["_meta"] == p["_meta"]
    for k, v in p.items():
        if k != "_meta":
            np.testing.assert_array_equal(back[k], v)
    # the file is the JAX package's layout: it loads there as its init
    jp = jbf.load_params(path)
    for k, v in jbf.init_params(**TINY).items():
        if k != "_meta":
            np.testing.assert_array_equal(jp[k], v)


def test_load_params_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tbf.load_params(str(tmp_path / "nope.npz"))
