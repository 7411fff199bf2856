"""Checkpoints of the port against the JAX package's, and the host API's
checkpoint, resume and rollback.

A checkpoint written by either package loads in the other with every leaf
equal, dtype included. On the CPU a resumed run, a chunked run and the
uninterrupted run are equal bit for bit (tests/test_utils.py:46, :264,
:283 hold the JAX package to rtol 1e-5; the port's eager loop repeats the
same operations on the same values, so it is held to equality).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from pyfasst_tpu.models.components import (
    FasstParams as JParams, SpatialComp as JSpat, SpectralComp as JSpec,
)
from pyfasst_tpu.utils import checkpoint as jckpt
import pyfasst_tpu_torch
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.ops.gem import run_gem
from pyfasst_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)


def _jax_params(case, rng, F=20, N=15):
    """tests/test_utils.py's checkpoint fixtures: inst + conv with a free FW
    ("mixed"), a source-filter second chain ("simm"), a full-rank conv
    source ("rank2")."""
    f32 = jnp.float32
    if case == "simm":
        comp = JSpec(FB=jnp.asarray(0.5 + rng.random((F, 4)), f32),
                     TW=jnp.asarray(0.5 + rng.random((4, N)), f32),
                     FB2=jnp.asarray(0.5 + rng.random((F, 3)), f32),
                     TW2=jnp.asarray(0.5 + rng.random((3, N)), f32),
                     free=(False, False, True, False))
        return JParams(spat=(JSpat(A=jnp.asarray([[0.9], [0.4]], f32)),),
                       spec=(comp,))
    R = 2 if case == "rank2" else 1
    A1 = (rng.standard_normal((F, 2, R))
          + 1j * rng.standard_normal((F, 2, R))).astype(np.complex64)
    spat = (JSpat(A=jnp.asarray([[0.9], [0.4]], f32)),
            JSpat(A=jnp.asarray(A1), mix_type="conv", free=False))
    spec = (JSpec(FB=jnp.asarray(0.5 + rng.random((F, 3)), f32),
                  TW=jnp.asarray(0.5 + rng.random((3, N)), f32), spat_ind=0),
            JSpec(FB=jnp.asarray(0.5 + rng.random((F, 4)), f32),
                  FW=jnp.asarray(0.5 + rng.random((4, 4)), f32),
                  TW=jnp.asarray(0.5 + rng.random((4, N)), f32),
                  spat_ind=1, free=(True, True, True, False)))
    return JParams(spat=spat, spec=spec)


def _leaves_equal(jparams, tparams, b=0):
    """Every array of the JAX params equals clip b of the port's, dtype
    and all, and the structure matches."""
    assert len(jparams.spat) == len(tparams.spat)
    for jc, tc in zip(jparams.spat, tparams.spat):
        want = np.asarray(jc.A)
        got = tc.A[b].numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (tc.mix_type, tc.free) == (jc.mix_type, jc.free)
    for jc, tc in zip(jparams.spec, tparams.spec):
        for name in ("FB", "FW", "TW", "TB", "FB2", "TW2"):
            want, got = getattr(jc, name), getattr(tc, name)
            assert (want is None) == (got is None), name
            if want is not None:
                np.testing.assert_array_equal(got[b].numpy(),
                                              np.asarray(want))
        assert tc.free == tuple(jc.free) and tc.spat_ind == jc.spat_ind
        assert tc.constraint == jc.constraint


@pytest.mark.parametrize("case", ["mixed", "simm", "rank2"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_in_the_other_package(tmp_path, case, writer):
    rng = np.random.default_rng(len(case))
    jparams = _jax_params(case, rng)
    path = str(tmp_path / "ck.npz")
    extra = {"note": "hi"}
    arrays = {"logliks": np.arange(5, dtype=np.float32)}
    if writer == "jax":
        jckpt.save_params(path, jparams, iteration=17, extra=extra,
                          extra_arrays=arrays)
        tparams, it, got_extra = tckpt.load_params(path)
        _leaves_equal(jparams, tparams)
    else:
        tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
        tckpt.save_params(path, tparams, iteration=17, extra=extra,
                          extra_arrays=arrays)
        loaded, it, got_extra = jckpt.load_params(path)
        _leaves_equal(loaded, tparams)
        assert all(c.free2 == (False, True) and c.decode == "soft"
                   for c in loaded.spec)
    assert it == 17 and got_extra["note"] == "hi"
    np.testing.assert_array_equal(got_extra["logliks"], arrays["logliks"])
    assert not os.path.exists(path + ".tmp")


def test_stacked_checkpoint_keeps_the_clip_axis(tmp_path):
    """A bucket checkpoint keeps its stacked leading axis, in the layout
    the JAX batch path writes; the port reads the JAX one back as B = 3."""
    rng = np.random.default_rng(3)
    trees = [jax.tree.map(np.asarray, _jax_params("mixed", rng))
             for _ in range(3)]
    tparams = convert.params_from_numpy(trees)
    path = str(tmp_path / "bucket.npz")
    tckpt.save_params(path, tparams, iteration=4, stacked=True)
    jparams, it, _ = jckpt.load_params(path)
    assert it == 4 and jparams.spat[1].A.shape[0] == 3
    for b in range(3):
        _leaves_equal(jax.tree.map(lambda a: a[b], jparams), tparams, b)
    jckpt.save_params(path, jparams, iteration=4)
    back, _, _ = tckpt.load_params(path)
    assert back.batch == 3
    for b in range(3):
        _leaves_equal(jax.tree.map(lambda a: a[b], jparams), back, b)
    with pytest.raises(ValueError, match="B = 1"):
        tckpt.save_params(path, tparams)


def test_load_converts_dtype_and_refuses_state_models(tmp_path):
    rng = np.random.default_rng(4)
    jparams = _jax_params("mixed", rng)
    path = str(tmp_path / "ck.npz")
    jckpt.save_params(path, jparams)
    params, _, _ = tckpt.load_params(path, device="cpu", dtype=torch.float64)
    assert params.spat[0].A.dtype == torch.float64
    assert params.spat[1].A.dtype == torch.complex128
    assert params.spec[1].FW.dtype == torch.float64
    hmm = jparams.replace(spec=(jparams.spec[0].replace(
        trans=jnp.full((3, 3), 1.0 / 3), constraint="HMM"),
        jparams.spec[1]))
    jckpt.save_params(path, hmm)
    # state models load since the discrete-state port: trans with its
    # clip axis, the constraint and decode fields as written
    params, _, _ = tckpt.load_params(path)
    assert params.spec[0].constraint == "HMM"
    assert params.spec[0].decode == "soft"
    np.testing.assert_array_equal(params.spec[0].trans[0].numpy(),
                                  np.full((3, 3), 1.0 / 3, np.float32))


def _tiny_model(tmp_path, nan_bin=False):
    """tests/test_utils.py::_tiny_fasst on the port: 1 s at 8 kHz, wlen
    256, 9 iterations."""
    rng = np.random.default_rng(11)
    fs = 8000
    t = np.arange(fs) / fs
    mix = np.stack([0.5 * np.sin(2 * np.pi * 300 * t)
                    + 0.2 * rng.standard_normal(fs),
                    0.3 * np.sin(2 * np.pi * 300 * t)
                    + 0.4 * rng.standard_normal(fs)], 1)
    p = str(tmp_path / "m.wav")
    scipy.io.wavfile.write(p, fs, (mix * 2 ** 14).astype(np.int16))
    model = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
        p, nbComps=2, nbNMFComps=3, wlen=256, iter_num=9, device="cpu")
    if nan_bin:
        model.Xs = model.Xs.clone()
        model.Xs[0, 3, 2, 0] = float("nan")
    return model


def _params_equal(a, b):
    for x, y in zip(convert.params_to_numpy(a), convert.params_to_numpy(b)):
        for cx, cy in zip(x["spat"], y["spat"]):
            np.testing.assert_array_equal(cx["A"], cy["A"])
        for cx, cy in zip(x["spec"], y["spec"]):
            for n in ("FB", "FW", "TW", "TB"):
                if cx[n] is not None:
                    np.testing.assert_array_equal(cx[n], cy[n])


def test_chunked_checkpoint_run_is_the_straight_run(tmp_path):
    m1 = _tiny_model(tmp_path)
    ll_straight = m1.estim_param_a_posteriori()
    m2 = _tiny_model(tmp_path)
    ck = str(tmp_path / "ck.npz")
    ll_chunked = m2.estim_param_a_posteriori(checkpoint_path=ck,
                                             checkpoint_every=4)
    np.testing.assert_array_equal(ll_chunked, ll_straight)
    _params_equal(m1.params, m2.params)
    _, it, _ = jckpt.load_params(ck)          # the final iteration, in JAX
    assert it == 9
    with pytest.raises(ValueError, match="checkpoint_path"):
        m2.estim_param_a_posteriori(checkpoint_every=4)


@pytest.mark.parametrize("every", [None, 3])
def test_resume_from_checkpoint_is_the_straight_run(tmp_path, every):
    """Save at iteration 6 (through run_gem, as a killed run leaves it),
    load into a fresh model, resume: the same logliks and parameters, bit
    for bit, with or without chunks after the resume."""
    m1 = _tiny_model(tmp_path)
    ll_ref = m1.estim_param_a_posteriori()
    m2 = _tiny_model(tmp_path)
    m2.params, _ = run_gem(m2.params, m2.Xs, m2.cfg, start_iter=0,
                           end_iter=6)
    ck = str(tmp_path / "mid.npz")
    m2.save_checkpoint(ck, iteration=6)
    m3 = _tiny_model(tmp_path)
    start = m3.load_checkpoint(ck)
    assert start == 6
    ll = m3.estim_param_a_posteriori(
        start_iter=start, checkpoint_path=every and ck,
        checkpoint_every=every)
    np.testing.assert_array_equal(ll[6:], ll_ref[6:])
    assert np.all(ll[:6] == 0)
    _params_equal(m1.params, m3.params)


def test_divergence_rolls_back_to_checkpoint(tmp_path):
    m = _tiny_model(tmp_path, nan_bin=True)
    p0 = convert.params_to_numpy(m.params)
    ck = str(tmp_path / "g.npz")
    with pytest.raises(RuntimeError, match="diverged.*checkpoint: .*g.npz"):
        m.estim_param_a_posteriori(checkpoint_path=ck, checkpoint_every=3)
    for x, y in zip(p0[0]["spec"], convert.params_to_numpy(m.params)[0]
                    ["spec"]):
        np.testing.assert_array_equal(x["TW"], y["TW"])
    assert not os.path.exists(ck)             # no chunk finished


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX model's mid-run checkpoint, resumed by the port, lands where
    the JAX package's own resume does (float32, test_torch_model.py's
    bars: loglik rtol 1e-4, parameters within 5e-4 of their peak)."""
    from pyfasst_tpu.models.variants import MultiChanNMFInst_FASST as JModel
    from pyfasst_tpu.ops.gem import run_gem as jrun_gem
    m = _tiny_model(tmp_path)
    wav = str(tmp_path / "m.wav")
    jm = JModel(wav, nbComps=2, nbNMFComps=3, wlen=256, iter_num=9)
    ll_ref = jm.estim_param_a_posteriori()
    jm2 = JModel(wav, nbComps=2, nbNMFComps=3, wlen=256, iter_num=9)
    jm2.params, _ = jrun_gem(jm2.params, jm2.Xs, jm2.cfg, start_iter=0,
                             end_iter=5)
    ck = str(tmp_path / "jax.npz")
    jm2.save_checkpoint(ck, iteration=5)
    start = m.load_checkpoint(ck)
    ll = m.estim_param_a_posteriori(start_iter=start)
    np.testing.assert_allclose(ll[5:], ll_ref[5:], rtol=1e-4)
    for jc, tc in zip(jm.params.spec, m.params.spec):
        w = np.asarray(jc.TW)
        assert np.max(np.abs(tc.TW[0].numpy() - w)) < 5e-4 * np.max(w)
