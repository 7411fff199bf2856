"""The band-EM candidate of the port against the JAX package's
(spatial_init._band_em_probes, band_em_votes, glue_band_perms, _chain_glue;
reverb.blind_reverb_separate's band_em=).

Both packages start from the JAX package's spectral draws (injected, see
tests/test_torch_reverb.py). Decisions are compared: each band's picked
seed, the band alignments, the glue permutations, the picked run; vote
planes (argmax of converged separations) agree on at least 99% of the
power-weighted bins; images within 5e-4 of their peak.
"""
import numpy as np
import pytest
import torch

from pyfasst_tpu.models import reverb as jrv
from pyfasst_tpu.models import spatial_init as jsi
from pyfasst_tpu_torch.models import reverb as trv
from pyfasst_tpu_torch.models import spatial_init as tsi
from test_reverb_pipeline import _reverb_mixture
from test_torch_spatial_init import jax_draws

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def probes_both():
    """Band-EM probes of one plane in both packages (the port's from the
    JAX package's draws), and the shared init votes."""
    mp = pytest.MonkeyPatch()
    jax_draws(mp)
    try:
        X = _reverb_mixture(seed=3)
        votes = tsi.consensus_votes(X, 2, n_seeds=3, backend="numpy")
        kw = dict(band_width=16, iters=20, votes_init=votes)
        yield X, tsi._band_em_probes(X, 2, device="cpu", **kw), \
            jsi._band_em_probes(X, 2, **kw)
    finally:
        mp.undo()


def _weighted_agreement(a, b, pw):
    return float(((a.argmax(-1) == b.argmax(-1)) * pw).sum() / pw.sum())


def test_band_em_probes_match_jax(probes_both):
    X, got, want = probes_both
    assert got.starts == want.starts == (0, 16, 32, 48, 49)
    assert got.Fb == want.Fb and got.names == want.names
    np.testing.assert_array_equal(got.pick, want.pick)
    np.testing.assert_allclose(got.ll, want.ll, rtol=1e-4)
    assert (got.lab == np.asarray(want.lab)).mean() > 0.99
    np.testing.assert_allclose(got.env, want.env, rtol=2e-3,
                               atol=2e-3 * want.env.max())


@pytest.mark.parametrize("align", ["envelope", "init", "spatial"])
def test_band_em_votes_match_jax(probes_both, align):
    X, got, want = probes_both
    vt, dt = tsi.band_em_votes(X, 2, band_align=align, probes=got,
                               return_detail=True, device="cpu")
    vj, dj = jsi.band_em_votes(X, 2, band_align=align, probes=want,
                               return_detail=True)
    np.testing.assert_array_equal(dt["inv"][align], dj["inv"][align])
    assert _weighted_agreement(vt, vj, got.pw) >= 0.99
    np.testing.assert_allclose(vt.sum(-1), 1.0)


def test_glue_band_perms_match_jax(probes_both, monkeypatch):
    jax_draws(monkeypatch)
    X, got, want = probes_both
    perms, margins = tsi.glue_band_perms(X, 2, got, glue_iters=8,
                                         chunk=4, device="cpu")
    jperms, jmargins = jsi.glue_band_perms(X, 2, want, glue_iters=8,
                                           chunk=4)
    np.testing.assert_array_equal(perms, jperms)
    assert perms.shape == (4, 2) and margins.shape == (4,)
    np.testing.assert_array_equal(tsi._chain_glue(perms, 2),
                                  jsi._chain_glue(jperms, 2))


def test_blind_reverb_band_em_matches_jax(monkeypatch):
    """band_em=16 adds the bandem and bandem-a candidates; with two EM
    seeds select=None resolves to consistency in both packages."""
    jax_draws(monkeypatch)
    X = _reverb_mixture(seed=9)
    kw = dict(iters=12, em_seeds=2, reseed_rounds=0, nmf_comps=3, chunk=4,
              n_seeds=3, band_em=16)
    Yj, ij = jrv.blind_reverb_separate(X, J=2, **kw)
    Yt, it = trv.blind_reverb_separate(X, J=2, device="cpu", **kw)
    assert it["select"] == ij["select"] == "consistency"
    assert it["history"][0]["pool"] == ij["history"][0]["pool"]
    assert it["picked"] == ij["picked"]
    assert it["consistency"] == pytest.approx(ij["consistency"], abs=2e-4)
    assert np.abs(Yt - Yj).max() < 5e-4 * np.abs(Yj).max()
