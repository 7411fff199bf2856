"""The port's random draws against jax.random, bit for bit.

pyfasst_tpu_torch/utils/prng.py is a NumPy copy of jax.random's threefry
(partitionable counters, the default of the installed JAX): PRNGKey,
split, fold_in and uniform must give jax.random's bits for seeds 0, 7,
120 and 1005, in float32 and (under x64) float64. Then every place the
port draws a random init must give the JAX package's initial parameters
bit for bit for the same seed and shapes: the FASST models
(MultiChanNMFInst_FASST, MultiChanNMFConv at ranks 1 and 2, MultiChanHMM
with its fold_in, multiChanSourceF0Filter), the blind pools' EM seeds
(spatial_init._em_seed_spec) and batch_separate_files' per-clip inits.
No tolerance: the draws are equal or the test fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from jax import enable_x64

import pyfasst_tpu
import pyfasst_tpu_torch
from pyfasst_tpu.models import components as jcomp
from pyfasst_tpu_torch.models import components as tcomp
from pyfasst_tpu_torch.models import spatial_init as tsi
from pyfasst_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = (0, 7, 120, 1005)
SHAPES = ((1025, 4), (4, 158), (5, 300), (3,), (), (2, 3, 7))
FS = 16000


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    k, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _eq(jax.random.key_data(k), prng.key_data(pk))
    for n in (2, 3, 7):
        _eq(jax.random.split(k, n), prng.split(pk, n))
    for d in (0, 1, 5, 2 ** 31 + 3):
        _eq(jax.random.fold_in(k, d), prng.fold_in(pk, d))
    # chains of both
    k2 = jax.random.fold_in(jax.random.split(k, 4)[3], 1)
    pk2 = prng.fold_in(prng.split(pk, 4)[3], 1)
    _eq(jax.random.split(k2, 5), prng.split(pk2, 5))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_float32(seed):
    k, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for sub, psub in zip(jax.random.split(k, 3), prng.split(pk, 3)):
        for shape in SHAPES:
            _eq(jax.random.uniform(sub, shape), prng.uniform(psub, shape))
            _eq(jax.random.uniform(sub, shape, minval=-2.5, maxval=3.7),
                prng.uniform(psub, shape, minval=-2.5, maxval=3.7))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_float64(seed):
    pk = prng.PRNGKey(seed)
    with enable_x64():
        k = jax.random.PRNGKey(seed)
        for sub, psub in zip(jax.random.split(k, 3), prng.split(pk, 3)):
            for shape in SHAPES:
                _eq(jax.random.uniform(sub, shape, jnp.float64),
                    prng.uniform(psub, shape, np.float64))
                _eq(jax.random.uniform(sub, shape, jnp.float64, 0.3, 2.0),
                    prng.uniform(psub, shape, np.float64, 0.3, 2.0))
            bits = jax.random.bits(sub, (4, 9), jnp.uint64)
            _eq(bits, prng.random_bits(psub, 64, (4, 9)))


@pytest.mark.parametrize("seed", SEEDS)
def test_init_nmf_comp_and_inst_mixing(seed):
    """components.init_nmf_comp (both structures) and init_inst_mixing
    from a key (its last word, as the JAX package takes it)."""
    basis = np.random.default_rng(seed).random((33, 5))
    for fixed in (None, basis):
        j = jcomp.init_nmf_comp(jax.random.PRNGKey(seed), 33, 21, 4,
                                spat_ind=1, fixed_FB=fixed)
        t = tcomp.init_nmf_comp(prng.PRNGKey(seed), 33, 21, 4, spat_ind=1,
                                fixed_FB=fixed)
        for name in ("FB", "FW", "TW"):
            if getattr(j, name) is None:
                assert getattr(t, name) is None
                continue
            _eq(np.asarray(getattr(j, name)), getattr(t, name)[0].numpy())
        assert tuple(j.free) == tuple(t.free)
    ja = jcomp.init_inst_mixing(jax.random.PRNGKey(seed), 2, 1, 3)
    ta = tcomp.init_inst_mixing(prng.PRNGKey(seed), 2, 1, 3)
    for a, b in zip(ja, ta):
        _eq(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", (0, 120))
def test_em_seed_spec(seed):
    """The blind pools' EM seed draws: split(PRNGKey(seed), J), one
    init_nmf_comp per source (JAX spatial_init.py:1139-1143)."""
    J, F, N, K = 3, 40, 27, 6
    keys = jax.random.split(jax.random.PRNGKey(seed), J)
    spec = tsi._em_seed_spec(seed, J, F, N, K, device="cpu")
    for j in range(J):
        c = jcomp.init_nmf_comp(keys[j], F, N, K, spat_ind=j)
        _eq(np.asarray(c.FB), spec[j].FB[0].numpy())
        _eq(np.asarray(c.TW), spec[j].TW[0].numpy())
        assert spec[j].spat_ind == j


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    rng = np.random.default_rng(3)
    x = 0.3 * rng.standard_normal((6000, 2))
    path = str(tmp_path_factory.mktemp("prng") / "mix.wav")
    scipy.io.wavfile.write(path, FS, np.round(x * 32767).astype(np.int16))
    return path


def _spec_eq(jparams, tparams):
    assert len(jparams.spec) == len(tparams.spec)
    for jc, tc in zip(jparams.spec, tparams.spec):
        for name in ("FB", "FW", "TW", "TB", "FB2", "TW2"):
            a, b = getattr(jc, name), getattr(tc, name)
            assert (a is None) == (b is None), name
            if a is not None:
                _eq(np.asarray(a), b[0].numpy())


MODELS = {
    "inst": ("MultiChanNMFInst_FASST", dict(nbComps=3, nbNMFComps=4)),
    "inst_erb": ("MultiChanNMFInst_FASST",
                 dict(nbComps=2, nbNMFComps=3, freq_basis="erb",
                      n_bands=8)),
    "conv": ("MultiChanNMFConv", dict(nbComps=3, nbNMFComps=4)),
    "fullrank": ("MultiChanNMFConv",
                 dict(nbComps=2, nbNMFComps=5, spatial_rank=2)),
    "hmm": ("MultiChanHMM", dict(nbComps=2, nbStates=4)),
    "simm": ("multiChanSourceF0Filter",
             dict(nbComps=3, nbNMFComps=4, n_f0=20)),
}


@pytest.mark.parametrize("seed", (0, 120))
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_model_inits(wav, kind, seed):
    """Each model's spectral init (and mixing) equals the JAX package's
    for the same seed, in float32."""
    cls, kw = MODELS[kind]
    kw = dict(kw, wlen=256, seed=seed)
    jm = getattr(pyfasst_tpu, cls)(wav, **kw)
    tm = getattr(pyfasst_tpu_torch, cls)(wav, device="cpu", **kw)
    _spec_eq(jm.params, tm.params)
    for jc, tc in zip(jm.params.spat, tm.params.spat):
        _eq(np.asarray(jc.A), tc.A[0].numpy())


def test_model_inits_float64(wav):
    """dtype='float64' draws 64-bit words, as the JAX package under x64."""
    kw = dict(nbComps=2, nbNMFComps=4, wlen=256, seed=7, dtype="float64")
    tm = pyfasst_tpu_torch.MultiChanNMFInst_FASST(wav, device="cpu", **kw)
    with enable_x64():
        jm = pyfasst_tpu.MultiChanNMFInst_FASST(wav, **kw)
        _spec_eq(jm.params, tm.params)
    assert tm.params.spec[0].FB.dtype == torch.float64


def test_batch_separate_files_inits(wav, tmp_path, monkeypatch):
    """batch_separate_files' per-clip make_params: clip i from
    split(PRNGKey(seed + i), nbComps), in both packages (the batch runs
    themselves are replaced by a stub that keeps make_params)."""
    import shutil

    import pyfasst_tpu.parallel.batch as jbatch
    import pyfasst_tpu_torch.parallel.batch as tbatch

    paths = [wav, str(tmp_path / "b.wav")]
    shutil.copy(wav, paths[1])
    got = {}

    def stub(key):
        def fake(Xs, make_params, cfg, **kw):
            got[key] = make_params
            imgs = [np.zeros((2,) + tuple(np.shape(x)), np.complex64)
                    for x in Xs]
            return imgs, [np.zeros(cfg.niter, np.float32) for _ in Xs]
        return fake

    monkeypatch.setattr(jbatch, "batch_separate", stub("jax"))
    monkeypatch.setattr(tbatch, "batch_separate", stub("port"))
    kw = dict(nbComps=2, nbNMFComps=3, wlen=256, iters=2, seed=11)
    jbatch.batch_separate_files(paths, str(tmp_path / "j"), **kw)
    tbatch.batch_separate_files(paths, str(tmp_path / "t"), device="cpu",
                                **kw)
    for i in range(2):
        _spec_eq(got["jax"](129, 128, i), got["port"](129, 128, i))
