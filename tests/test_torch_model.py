"""The port's whole slice, WAV in to WAVs out, against the JAX package.

Both packages read the same 1 s stereo WAV and start from the JAX model's
initial parameters (copied in through convert.params_from_numpy), then run
30 GEM iterations at wlen 256, in float32. Bars: loglik rtol 1e-4, images
within 5e-4 of their peak (16 PCM16 steps in the written WAVs). Thirty
iterations of rounding-order differences compound through the
multiplicative updates and the fast end of a short annealing schedule:
measured on this clip, each float32 run lies ~6e-5 of the peak from a
float64 JAX run (JAX 6.2e-5, the port 5.2e-5) and the two float32 runs
1.1e-4 apart. 5e-4 of the peak is -66 dB, far below the 0.1 dB that would
be audible.
"""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.io.wavfile
import torch

import pyfasst_tpu
import pyfasst_tpu_torch
from pyfasst_tpu_torch import convert
from pyfasst_tpu_torch.models.fasst import resolve_device
from pyfasst_tpu_torch.utils.config import GEMConfig, load_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FS = 16000


def _write_mixture(path, seconds=1.0, seed=0):
    """Two panned sources (a vibrato tone, gated noise) as PCM16 stereo."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    s1 = 0.4 * np.sin(2 * np.pi * (300 * t + 3 * np.sin(2 * np.pi * t)))
    s2 = 0.3 * rng.standard_normal(t.size) * (np.sin(2 * np.pi * 2 * t) > 0)
    mix = np.outer(s1, [0.95, 0.31]) + np.outer(s2, [0.31, 0.95])
    mix = 0.9 * mix / np.max(np.abs(mix))
    scipy.io.wavfile.write(path, FS, np.round(mix * 32767).astype(np.int16))
    return path


@pytest.fixture(scope="module")
def both_models(tmp_path_factory):
    wav = _write_mixture(str(tmp_path_factory.mktemp("wav") / "mix.wav"))
    kw = dict(nbComps=2, nbNMFComps=4, wlen=256, iter_num=30)
    jmodel = pyfasst_tpu.MultiChanNMFInst_FASST(wav, **kw)
    tmodel = pyfasst_tpu_torch.MultiChanNMFInst_FASST(wav, device="cpu",
                                                      **kw)
    tmodel.params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jmodel.params))
    jll = jmodel.estim_param_a_posteriori()
    tll = tmodel.estim_param_a_posteriori()
    return jmodel, tmodel, jll, tll


def test_model_spectra_match_jax(both_models):
    jmodel, tmodel, _, _ = both_models
    assert (tmodel.F, tmodel.N) == (jmodel.F, jmodel.N)
    want = np.asarray(jmodel.Xs)
    got = tmodel.Xs[0].numpy()
    assert np.max(np.abs(got - want)) < 2e-6 * np.max(np.abs(want))
    np.testing.assert_allclose(tmodel._scale, jmodel._scale, rtol=1e-6)


def test_model_logliks_match_jax(both_models):
    _, _, jll, tll = both_models
    assert tll.shape == jll.shape == (30,)
    assert np.all(np.isfinite(tll))
    np.testing.assert_allclose(tll, jll, rtol=1e-4)


def test_model_images_match_jax(both_models):
    jmodel, tmodel, _, _ = both_models
    want = jmodel.separated_images()
    got = tmodel.separated_images()
    assert got.shape == want.shape == (2, FS, 2)
    assert np.max(np.abs(got - want)) < 5e-4 * np.max(np.abs(want))
    # Wiener conservation: the images sum back to the mixture
    mix = tmodel.audio.data
    assert np.linalg.norm(got.sum(0) - mix) < 0.05 * np.linalg.norm(mix)


def test_model_spatial_filter_matches_jax(both_models, tmp_path):
    jmodel, tmodel, _, _ = both_models
    jpaths = jmodel.separate_spatial_filter_comp(str(tmp_path / "jax"))
    tpaths = tmodel.separate_spatial_filter_comp(str(tmp_path / "torch"))
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths]
    for jp, tp in zip(jpaths, tpaths):
        _, a = scipy.io.wavfile.read(jp)
        _, b = scipy.io.wavfile.read(tp)
        assert np.max(np.abs(a.astype(int) - b.astype(int))) <= 16


def test_model_writes_wavs(both_models, tmp_path):
    _, tmodel, _, _ = both_models
    paths = tmodel.separate_spat_comps(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["mix_est_0.wav",
                                                    "mix_est_1.wav"]
    ys = tmodel.retrieveSubsrcSignals()
    for j, p in enumerate(paths):
        sr, data = scipy.io.wavfile.read(p)
        assert sr == FS and data.dtype == np.int16 and data.shape == (FS, 2)
        assert np.max(np.abs(data)) > 0
        np.testing.assert_allclose(data / 32767.0, ys[j], atol=2e-4)


def test_model_chunked_estimation_is_exact(tmp_path):
    """Chunks of 4 iterations, each saved to a checkpoint, give the
    uninterrupted run's logliks bit for bit; chunks need a checkpoint path,
    as in the JAX package."""
    wav = _write_mixture(str(tmp_path / "m.wav"), seconds=0.25, seed=1)
    ck = str(tmp_path / "ck.npz")
    lls = []
    for every in (None, 4):
        m = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
            wav, nbComps=2, nbNMFComps=3, wlen=256, iter_num=10,
            device="cpu")
        lls.append(m.estim_param_a_posteriori(
            checkpoint_path=ck if every else None, checkpoint_every=every))
    np.testing.assert_array_equal(lls[0], lls[1])
    assert m.load_checkpoint(ck) == 10
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        m.estim_param_a_posteriori(checkpoint_every=4)


def test_port_imports_no_jax(tmp_path):
    """A separation through the port (the inst model with a checkpointed
    run, the conv model with DEMIX and the ERB basis, a 3-channel model,
    batch_separate) loads neither jax nor pyfasst_tpu."""
    code = """
import sys
import numpy as np
import torch
import pyfasst_tpu_torch
from pyfasst_tpu_torch import convert
rng = np.random.default_rng(0)
x = rng.standard_normal((4000, 2)) * 0.1
m = pyfasst_tpu_torch.MultiChanNMFInst_FASST(x, fs=16000, nbComps=2,
                                             nbNMFComps=2, wlen=256,
                                             iter_num=3, device="cpu")
ll = m.estim_param_a_posteriori(checkpoint_path="ck.npz",
                                checkpoint_every=2)
assert m.load_checkpoint("ck.npz") == 3
ys = m.separated_images()
assert ys.shape == (2, 4000, 2) and np.all(np.isfinite(ll))
m3 = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
    rng.standard_normal((4000, 3)) * 0.1, fs=16000, nbComps=2, nbNMFComps=2,
    wlen=256, iter_num=3, device="cpu")
assert np.all(np.isfinite(m3.estim_param_a_posteriori()))
assert m3.separated_images().shape == (2, 4000, 3)
imgs, lls = pyfasst_tpu_torch.batch_separate(
    [m.Xs[0], m.Xs[0][:, :20]], lambda F, N, i: convert.params_from_numpy(
        {"spat": [{"A": np.ones((2, 1))}, {"A": np.eye(2)[:, :1] + 0.1}],
         "spec": [{"FB": np.ones((F, 2)), "TW": np.ones((2, N)),
                   "spat_ind": j} for j in range(2)]}),
    pyfasst_tpu_torch.GEMConfig(niter=2), device="cpu", granularity=16)
assert imgs[1].shape == (2, 129, 20, 2)
dm = pyfasst_tpu_torch.DEMIX(x, fs=16000, wlen=256)   # DEMIX and its STFT
dm.comp_parameters(K=2)
c = pyfasst_tpu_torch.MultiChanNMFConv(x, fs=16000, nbComps=2, nbNMFComps=2,
                                       wlen=256, iter_num=3, spatial_rank=2,
                                       init_mixing=dm.mixing(129),
                                       freq_basis="erb", n_bands=8,
                                       device="cpu")
assert np.all(np.isfinite(c.estim_param_a_posteriori()))
assert c.separated_images().shape == (2, 4000, 2)
from pyfasst_tpu_torch.ops import cuda_estep, _build  # kernel modules too
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "flax"))
             or n == "pyfasst_tpu" or n.startswith("pyfasst_tpu."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pyfasst_tpu_torch.MultiChanNMFInst_FASST(
            np.zeros((4000, 2)), fs=16000, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("entry", ["MultiChanNMFInst_FASST",
                                   "MultiChanNMFConv", "STFT"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """With no `device`, each entry point asks for the card: without one
    it raises, naming the CPU as the caller's choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "STFT":
        from pyfasst_tpu_torch.tf.stft import STFT as cls
        owner, args, kw = cls, (), dict(wlen=256, fs=16000)
    else:
        cls = getattr(pyfasst_tpu_torch, entry)
        owner, args, kw = pyfasst_tpu_torch.FASST, (np.zeros((4000, 2)),), \
            dict(fs=16000)
    assert inspect.signature(owner).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        cls(*args, **kw)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    """No card (CUDA hidden), or the script without the package: non-zero
    exit and no ok line."""
    script = REPO / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_config_loader(tmp_path):
    cfg = load_config({"niter": 7, "annealing": "no_ann"})
    assert cfg == GEMConfig(niter=7, annealing="no_ann")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"niter": 5}))
    assert load_config(str(path)).niter == 5
    assert load_config(cfg) is cfg
    with pytest.raises(ValueError, match="use_pallas"):
        load_config({"use_pallas": False})
    with pytest.raises(TypeError):
        load_config(3)


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    trees = [{"spat": [{"A": rng.random((2, 1)), "mix_type": "inst",
                        "free": True},
                       {"A": rng.random((5, 2, 2)) + 1j, "mix_type": "conv",
                        "free": False}],
              "spec": [{"FB": rng.random((5, 3)), "TW": rng.random((3, 4)),
                        "spat_ind": j, "free": (True, False, True, False)}
                       for j in range(2)]} for _ in range(3)]
    params = convert.params_from_numpy(trees, dtype=torch.float64)
    assert params.batch == 3
    assert params.spat[1].A.dtype == torch.complex128
    assert params.spat[1].free is False
    back = convert.params_to_numpy(params)
    for t, b in zip(trees, back):
        for cs, cb in zip(t["spat"], b["spat"]):
            np.testing.assert_array_equal(cs["A"], cb["A"])
            assert cb["mix_type"] == cs["mix_type"]
        for cs, cb in zip(t["spec"], b["spec"]):
            np.testing.assert_array_equal(cs["FB"], cb["FB"])
            np.testing.assert_array_equal(cs["TW"], cb["TW"])
            assert cb["FW"] is None and cb["spat_ind"] == cs["spat_ind"]
