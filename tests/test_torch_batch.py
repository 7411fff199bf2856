"""The port's bucketed batch separation against the JAX package's
(tests/test_sharding.py:85, :117, :158, :211), on the same clips and
initial parameters made with numpy from a seed.

Per clip: images within 5e-4 of their peak and logliks rtol 1e-4 (the bars
of tests/test_torch_model.py; float32 runs of the two packages in their own
rounding orders). The port against itself (resume, endpoints) is exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.models.components import (
    FasstParams as JParams, SpatialComp as JSpat, SpectralComp as JSpec,
)
from pyfasst_tpu.parallel import make_mesh
from pyfasst_tpu.parallel.batch import batch_separate as j_batch_separate
from pyfasst_tpu.utils.config import GEMConfig as JConfig
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.ops.gem import endpoints_from_power, run_gem
from pyfasst_tpu_torch.parallel import batch
from pyfasst_tpu_torch.utils.config import GEMConfig

torch.set_num_threads(1)
F = 33


def _tree(F_, Npad, i, I=2):
    """One clip's initial parameters (tests/test_sharding.py's
    make_params) as a numpy tree."""
    r = np.random.default_rng(i)
    return {"spat": [{"A": (np.abs(r.standard_normal((I, 1))) + 0.4)
                      .astype(np.float32), "mix_type": "inst"}
                     for _ in range(2)],
            "spec": [{"FB": (0.5 + r.random((F_, 3))).astype(np.float32),
                      "TW": (0.5 + r.random((3, Npad))).astype(np.float32),
                      "spat_ind": j} for j in range(2)]}


def make_params(F_, Npad, i):
    return convert.params_from_numpy(_tree(F_, Npad, i))


def j_make_params(F_, Npad, i):
    t = _tree(F_, Npad, i)
    return JParams(spat=tuple(JSpat(A=jnp.asarray(s["A"])) for s in t["spat"]),
                   spec=tuple(JSpec(FB=jnp.asarray(s["FB"]),
                                    TW=jnp.asarray(s["TW"]),
                                    spat_ind=s["spat_ind"])
                              for s in t["spec"]))


def _clips(lengths, seed=0, I=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((F, n, I))
             + 1j * rng.standard_normal((F, n, I))).astype(np.complex64)
            for n in lengths]


def _close(imgs, lls, want_imgs, want_lls):
    for got, want, gl, wl in zip(imgs, want_imgs, lls, want_lls):
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < 5e-4 * np.max(np.abs(want))
        np.testing.assert_allclose(gl, wl, rtol=1e-4)


def test_frame_buckets_and_padding():
    assert batch.frame_buckets([10, 100, 129, 200], granularity=128) == {
        128: [0, 1], 256: [2, 3]}
    X = torch.ones((3, 5, 2), dtype=torch.complex64)
    P = batch._pad_frames(X, 8)
    assert P.shape == (3, 8, 2) and bool((P[:, 5:] == 0).all())
    assert batch._bucket_ckpt_path("d", 64) == os.path.join("d",
                                                            "bucket_64.npz")


def test_batch_params_concatenates_clips():
    p = batch.batch_params([make_params(F, 8, i) for i in range(3)])
    assert p.batch == 3
    for b in range(3):
        np.testing.assert_array_equal(p.spec[1].TW[b].numpy(),
                                      _tree(F, 8, b)["spec"][1]["TW"])


@pytest.mark.parametrize("lengths,granularity", [((40, 44, 150), 64),
                                                 ((40,), 128)])
def test_batch_separate_matches_jax(lengths, granularity):
    """Variable lengths in two buckets, and one clip padded 3.2x (the
    annealing endpoints come from its unpadded frames in both packages)."""
    Xs = _clips(lengths)
    cfg = dict(niter=6)
    want_imgs, want_lls = j_batch_separate(Xs, j_make_params, JConfig(**cfg),
                                           mesh=make_mesh(8),
                                           granularity=granularity)
    imgs, lls = batch.batch_separate(Xs, make_params, GEMConfig(**cfg),
                                     device="cpu", granularity=granularity)
    for i, n in enumerate(lengths):
        assert imgs[i].shape == (2, F, n, 2) and lls[i].shape == (6,)
    _close(imgs, lls, want_imgs, want_lls)


def test_batch_padding_preserves_annealing_endpoints():
    """The padded clip's run equals run_gem on the padded clip with the
    endpoints of its unpadded frames, bit for bit, and differs from the
    run with the endpoints diluted by the padding."""
    X = _clips((40,), seed=1)[0]
    cfg = GEMConfig(niter=4)
    _, lls = batch.batch_separate([X], make_params, cfg, device="cpu",
                                  granularity=128)
    Xt = torch.as_tensor(X)
    Xp = batch._pad_frames(Xt, 128)[None]
    se = endpoints_from_power(torch.mean(Xt.abs() ** 2, dim=(1, 2))[None],
                              cfg)
    _, ll_ref = run_gem(make_params(F, 128, 0), Xp, cfg, sigma_endpoints=se)
    np.testing.assert_array_equal(lls[0], ll_ref[0].numpy())
    _, ll_diluted = run_gem(make_params(F, 128, 0), Xp, cfg)
    assert not np.allclose(lls[0], ll_diluted[0].numpy(), rtol=1e-5)


class Killed(RuntimeError):
    pass


def _kill(Npad, iteration):
    raise Killed(f"simulated preemption at bucket {Npad} it {iteration}")


def test_batch_checkpoint_resume(tmp_path):
    """Kill the first bucket after its first chunk, resume: the same
    logliks and images as the uninterrupted run, bit for bit; finished
    buckets delete their files. The JAX package reads the port's bucket
    checkpoint."""
    from pyfasst_tpu.utils.checkpoint import load_params as j_load
    Xs = _clips((40, 44, 150), seed=2)
    cfg = GEMConfig(niter=6)
    ref_imgs, ref_lls = batch.batch_separate(Xs, make_params, cfg,
                                             device="cpu", granularity=64)
    ckpt_dir = str(tmp_path / "ckpts")
    with pytest.raises(Killed):
        batch.batch_separate(Xs, make_params, cfg, device="cpu",
                             granularity=64, checkpoint_dir=ckpt_dir,
                             checkpoint_every=2, on_checkpoint=_kill)
    saved = os.listdir(ckpt_dir)
    assert saved == ["bucket_64.npz"]
    jp, it, extra = j_load(os.path.join(ckpt_dir, saved[0]))
    assert it == 2 and extra["clips"] == [0, 1] and extra["niter"] == 6
    assert jp.spec[0].TW.shape == (2, 3, 64)
    imgs, lls = batch.batch_separate(Xs, make_params, cfg, device="cpu",
                                     granularity=64, checkpoint_dir=ckpt_dir,
                                     checkpoint_every=2)
    assert os.listdir(ckpt_dir) == []
    for i in range(len(Xs)):
        np.testing.assert_array_equal(lls[i], ref_lls[i])
        np.testing.assert_array_equal(imgs[i], ref_imgs[i])
    with pytest.raises(ValueError, match="checkpoint_dir"):
        batch.batch_separate(Xs, make_params, cfg, device="cpu",
                             checkpoint_every=2)


def test_batch_checkpoint_mismatch_ignored(tmp_path):
    """A stale bucket checkpoint (another niter) is ignored, not resumed
    from."""
    X = _clips((40,), seed=3)
    ckpt_dir = str(tmp_path / "ckpts")
    with pytest.raises(Killed):
        batch.batch_separate(X, make_params, GEMConfig(niter=6),
                             device="cpu", granularity=64,
                             checkpoint_dir=ckpt_dir, checkpoint_every=2,
                             on_checkpoint=_kill)
    ref, ref_lls = batch.batch_separate(X, make_params, GEMConfig(niter=4),
                                        device="cpu", granularity=64)
    imgs, lls = batch.batch_separate(X, make_params, GEMConfig(niter=4),
                                     device="cpu", granularity=64,
                                     checkpoint_dir=ckpt_dir,
                                     checkpoint_every=2)
    np.testing.assert_array_equal(lls[0], ref_lls[0])
    np.testing.assert_array_equal(imgs[0], ref[0])


def test_batch_separate_three_channels():
    """Buckets of 3-channel clips take the general-I engine."""
    Xs = _clips((30, 50), seed=4, I=3)

    def params3(F_, Npad, i):
        return convert.params_from_numpy(_tree(F_, Npad, i, I=3))

    imgs, lls = batch.batch_separate(Xs, params3, GEMConfig(niter=3),
                                     device="cpu", granularity=32)
    assert [y.shape for y in imgs] == [(2, F, 30, 3), (2, F, 50, 3)]
    assert all(np.all(np.isfinite(ll)) for ll in lls)


def test_batch_separate_files(tmp_path):
    """WAV files in, stems out, through the bucketed path."""
    import scipy.io.wavfile
    rng = np.random.default_rng(5)
    paths = []
    for k, n in enumerate((4000, 6000)):
        p = str(tmp_path / f"clip{k}.wav")
        scipy.io.wavfile.write(p, 8000, np.round(
            0.3 * rng.standard_normal((n, 2)) * 32767).astype(np.int16))
        paths.append(p)
    report = batch.batch_separate_files(paths, str(tmp_path / "out"),
                                        wlen=256, iters=3, device="cpu")
    assert sorted(report) == ["clip0", "clip1"]
    for stem, n in (("clip0", 4000), ("clip1", 6000)):
        assert len(report[stem]["files"]) == 2
        assert np.isfinite(report[stem]["final_loglik"])
        sr, data = scipy.io.wavfile.read(report[stem]["files"][0])
        assert sr == 8000 and data.shape == (n, 2)
