"""The multiscale ladder of the port against the JAX package's
(reverb.blind_reverb_separate_multiscale and
FASST.estim_param_blind_reverb(multiscale_wlen=...)).

Both packages start from the JAX package's spectral draws (injected, see
tests/test_torch_reverb.py) and, for the parity run, the same front-end
bits. Decisions are compared at every stage; the coarse candidates agree
on at least 99% of the power-weighted bins (see the test for the images'
bar).
"""
import numpy as np
import pytest
import torch

import pyfasst_tpu_torch
from pyfasst_tpu.models import reverb as jrv
from pyfasst_tpu_torch.models import reverb as trv
from test_reverb_pipeline import _time_mixture
from test_torch_spatial_init import jax_draws

torch.set_num_threads(1)


def _weighted_agreement(a, b, pw):
    return float(((a.argmax(-1) == b.argmax(-1)) * pw).sum() / pw.sum())


class _JaxGrid:
    """The JAX package's STFT behind the port's transform interface, so
    both ladders see the same front-end bits (the two packages' FFTs differ
    by ~1e-7, which flips the odd near-tie vote of the fine grid and moves
    the coarse images by ~1% of their peak)."""

    def __init__(self, wlen, fs=4000):
        from pyfasst_tpu.tf.stft import STFT
        self.stft, self.wlen = STFT(wlen=wlen, fs=fs), wlen

    def computeTransform(self, x):
        from pyfasst_tpu.utils.misc import to_host_complex
        return torch.as_tensor(to_host_complex(
            self.stft.computeTransform(np.asarray(x))))

    def invertTransform(self, Y, nsamples):
        return torch.as_tensor(np.array(self.stft.invertTransform(
            np.asarray(Y), nsamples=nsamples)))


def test_multiscale_ladder_matches_jax(monkeypatch):
    """The ladder's decisions match at every stage. Its rung-2 votes are
    the argmax of converged float32 separations (2e-5 of the peak apart
    between the packages), so near-tie bins can flip: the coarse
    candidates agree on >= 99% of the power-weighted bins, and the coarse
    images, whose EM starts from them, within 1e-2 of their peak."""
    jax_draws(monkeypatch)
    coarse = {}
    for name, mod in (("jax", jrv), ("port", trv)):
        def spy(X, cands, J, orig=mod._pool_and_reseed, name=name, **kw):
            coarse[name] = (X, cands)
            return orig(X, cands, J, **kw)
        monkeypatch.setattr(mod, "_pool_and_reseed", spy)
    mix, _ = _time_mixture()
    kw = dict(fs=4000, iters=20, em_seeds=1, reseed_rounds=1, nmf_comps=3,
              chunk=4, n_seeds=3)
    Yj, ij = jrv.blind_reverb_separate_multiscale(
        mix, J=2, transform_fine=_JaxGrid(128).stft,
        transform_coarse=_JaxGrid(512).stft, **kw)
    Yt, it = trv.blind_reverb_separate_multiscale(
        mix, J=2, transform_fine=_JaxGrid(128),
        transform_coarse=_JaxGrid(512), device="cpu", **kw)
    assert Yt.shape == Yj.shape == (2, 257, Yj.shape[2], 2)
    assert it["fine"]["picked"] == ij["fine"]["picked"]
    assert it["picked"] == ij["picked"]
    assert it["picked"].split("|")[0].startswith(("ladder", "reseed"))
    assert [h["picked"] for h in it["history"]] == \
        [h["picked"] for h in ij["history"]]
    assert "params" not in it["fine"]
    (Xj, cj), (Xt, ct) = coarse["jax"], coarse["port"]
    np.testing.assert_array_equal(np.asarray(Xt), np.asarray(Xj))
    pw = (np.abs(Xj) ** 2).sum(-1)
    assert [n for n, _ in ct] == [n for n, _ in cj]
    for (_, vt), (_, vj) in zip(ct, cj):
        assert _weighted_agreement(vt, vj, pw) >= 0.99
    assert np.abs(Yt - Yj).max() < 1e-2 * np.abs(Yj).max()
    # on the port's own STFT grids: the same decisions
    Yp, ip = trv.blind_reverb_separate_multiscale(
        mix, J=2, wlen_fine=128, wlen_coarse=512, device="cpu", **kw)
    assert [h["picked"] for h in ip["history"]] == \
        [h["picked"] for h in ij["history"]]
    y0 = ip["transform"].invertTransform(torch.as_tensor(Yp[0]),
                                         nsamples=mix.shape[0])
    assert tuple(y0.shape) == mix.shape


def test_model_multiscale_entry():
    mix, _ = _time_mixture(seed=1)
    m = pyfasst_tpu_torch.MultiChanNMFConv(
        mix, fs=4000, wlen=512, iter_num=20, nbComps=2, nbNMFComps=3,
        spatial_rank=2, device="cpu")
    info = m.estim_param_blind_reverb(reseed_rounds=1, em_seeds=1,
                                      multiscale_wlen=128, chunk=4,
                                      n_seeds=3)
    ys = m.separated_images()
    assert ys.shape == (2, mix.shape[0], 2) and np.all(np.isfinite(ys))
    assert info["fine"]["picked"] and "transform" not in info
    with pytest.raises(ValueError, match="finer"):
        m.estim_param_blind_reverb(multiscale_wlen=512)
