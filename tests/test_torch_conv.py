"""The convolutive and full-rank slice of the port against the JAX package.

1. MultiChanNMFConv's initial mixing (its numpy draw, the rank expansion of
   an init_mixing) and the fixed ERB basis are bit-equal to the JAX
   model's for the same seed.
2. The slice end to end: a JAX MultiChanNMFConv (rank 1 with the ERB basis,
   and rank 2), 3 sources on a 1 s 16 kHz clip, wlen 256, 30 iterations;
   the port starts from the JAX model's parameters (convert). Bars as in
   tests/test_torch_model.py: loglik rtol 1e-4, images within 5e-4 of
   their peak.
The E-step kernel's plain version is held against the JAX package by
tests/test_torch_estep_general.py.
"""
import jax
import numpy as np
import pytest
import torch

import pyfasst_tpu
import pyfasst_tpu_torch
from pyfasst_tpu_torch import convert

torch.set_num_threads(1)

FS = 16000


# -- 1. initialization ---------------------------------------------------------

def _mixture(seconds=1.0, seed=0):
    """Three sources, each delayed and scaled on the second channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    srcs = [0.4 * np.sin(2 * np.pi * (300 * t + 3 * np.sin(2 * np.pi * t))),
            0.3 * rng.standard_normal(t.size)
            * (np.sin(2 * np.pi * 2 * t) > 0),
            np.convolve(rng.standard_normal(t.size), np.ones(8) / 8, "same")]
    mix = sum(np.stack([s, g * np.roll(s, d)], 1)
              for s, d, g in zip(srcs, [-2, 0, 3], [0.6, 1.0, 1.5]))
    return 0.9 * mix / np.max(np.abs(mix))


@pytest.mark.parametrize("rank", [1, 2])
def test_conv_default_init_matches_jax(rank):
    kw = dict(fs=FS, nbComps=3, nbNMFComps=2, wlen=256, spatial_rank=rank,
              seed=3)
    mix = _mixture(0.25)
    jm = pyfasst_tpu.MultiChanNMFConv(mix, **kw)
    tm = pyfasst_tpu_torch.MultiChanNMFConv(mix, device="cpu", **kw)
    for jc, tc in zip(jm.params.spat, tm.params.spat):
        assert tc.mix_type == "conv" and tc.A.dtype == torch.complex64
        np.testing.assert_array_equal(tc.A[0].numpy(), np.asarray(jc.A))
        assert tc.A.shape == (1, tm.F, 2, rank)
    for tc in tm.params.spec:
        assert tc.FW is None and tc.free == (True, False, True, False)


def test_conv_init_mixing_and_erb_basis_match_jax():
    mix = _mixture(0.25)
    rng = np.random.default_rng(1)
    F = 129
    init = np.exp(1j * rng.standard_normal((3, F, 2, 1))) \
        * (0.5 + rng.random((3, F, 2, 1)))
    kw = dict(fs=FS, nbComps=3, nbNMFComps=4, wlen=256, spatial_rank=2,
              init_mixing=init, freq_basis="erb", n_bands=16)
    jm = pyfasst_tpu.MultiChanNMFConv(mix, **kw)
    tm = pyfasst_tpu_torch.MultiChanNMFConv(mix, device="cpu", **kw)
    for jc, tc in zip(jm.params.spat, tm.params.spat):
        np.testing.assert_array_equal(tc.A[0].numpy(), np.asarray(jc.A))
    for jc, tc in zip(jm.params.spec, tm.params.spec):
        np.testing.assert_array_equal(tc.FB[0].numpy(), np.asarray(jc.FB))
        assert tc.FW.shape == (1, 16, 4) and tc.TW.shape == (1, 4, tm.N)
        assert tc.free == (False, True, True, False) == tuple(jc.free)


def test_inst_freq_basis_matches_jax():
    mix = _mixture(0.25)[:, :2]
    kw = dict(fs=FS, nbComps=2, nbNMFComps=3, wlen=256, freq_basis="mel",
              n_bands=12)
    jm = pyfasst_tpu.MultiChanNMFInst_FASST(mix, **kw)
    tm = pyfasst_tpu_torch.MultiChanNMFInst_FASST(mix, device="cpu", **kw)
    for jc, tc in zip(jm.params.spec, tm.params.spec):
        np.testing.assert_array_equal(tc.FB[0].numpy(), np.asarray(jc.FB))
        assert tc.free == (False, True, True, False)
    ll = tm.estim_param_a_posteriori(niter=3)
    assert np.all(np.isfinite(ll))


# -- 2. end to end -------------------------------------------------------------

_E2E = {"rank1_erb": dict(spatial_rank=1, freq_basis="erb", n_bands=16),
        "rank2": dict(spatial_rank=2)}


@pytest.fixture(scope="module")
def conv_models():
    out = {}
    mix = _mixture()
    for name, extra in _E2E.items():
        kw = dict(fs=FS, nbComps=3, nbNMFComps=4, wlen=256, iter_num=30,
                  **extra)
        jm = pyfasst_tpu.MultiChanNMFConv(mix, **kw)
        tm = pyfasst_tpu_torch.MultiChanNMFConv(mix, device="cpu", **kw)
        tm.params = convert.params_from_numpy(
            jax.tree.map(np.asarray, jm.params))
        out[name] = (jm, tm, jm.estim_param_a_posteriori(),
                     tm.estim_param_a_posteriori())
    return out


@pytest.mark.parametrize("name", sorted(_E2E))
def test_conv_model_logliks_match_jax(conv_models, name):
    _, _, jll, tll = conv_models[name]
    assert tll.shape == jll.shape == (30,)
    assert np.all(np.isfinite(tll))
    np.testing.assert_allclose(tll, jll, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(_E2E))
def test_conv_model_images_match_jax(conv_models, name):
    jm, tm, _, _ = conv_models[name]
    want = np.asarray(jm.separated_images())
    got = tm.separated_images()
    assert got.shape == want.shape == (3, FS, 2)
    assert np.max(np.abs(got - want)) < 5e-4 * np.max(np.abs(want))
    mix = tm.audio.data
    assert np.linalg.norm(got.sum(0) - mix) < 0.05 * np.linalg.norm(mix)


def test_conv_model_writes_wavs(conv_models, tmp_path):
    _, tm, _, _ = conv_models["rank2"]
    paths = tm.separate_spat_comps(str(tmp_path))
    assert len(paths) == 3 and all(p.endswith(".wav") for p in paths)
    assert tm.params.spat[0].A.shape == (1, 129, 2, 2)
