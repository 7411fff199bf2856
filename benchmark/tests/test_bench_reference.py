"""The plain reference agrees with the port at a tiny size on the CPU."""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from conftest import tiny
from harness import entries, prng, reference, traffic, wav

stft_m = importlib.import_module("pyfasst_tpu_torch.tf.stft")
gem_m = importlib.import_module("pyfasst_tpu_torch.ops.gem")
wiener_m = importlib.import_module("pyfasst_tpu_torch.ops.wiener")
comps = importlib.import_module("pyfasst_tpu_torch.models.components")

F64 = torch.float64


def _port(mix, A, FB, TW, model, dtype):
    """The bench pipeline of the port on the CPU in `dtype`."""
    J = A.shape[1]
    params = comps.FasstParams(
        spat=tuple(comps.SpatialComp(A=A[:, j, :, None].to(dtype))
                   for j in range(J)),
        spec=tuple(comps.SpectralComp(FB=FB[:, j].to(dtype),
                                      TW=TW[:, j].to(dtype), spat_ind=j)
                   for j in range(J)))
    cfg = entries.gem_config(model)
    win = torch.as_tensor(stft_m.sine_window(model["wlen"]), dtype=dtype)
    X = stft_m._stft_core(mix.to(dtype), win, model["wlen"], model["hop"])
    p, ll = gem_m.run_gem(params, X, cfg)
    Y = wiener_m.separate_sources(p, X, gem_m.annealing_endpoints(X, cfg)[1])
    ys = stft_m._istft_core(Y, win, model["wlen"], model["hop"],
                            mix.shape[1])
    return {"X": X, "logliks": ll, "ys": ys,
            "A": torch.stack([c.A[..., 0] for c in p.spat], 1),
            "FB": torch.stack([c.FB for c in p.spec], 1),
            "TW": torch.stack([c.TW for c in p.spec], 1)}


def _inputs(seed=4, niter=30):
    model, mix = tiny("stereo_nmf_end1e-3.b8", niter=niter)
    T, F, N = traffic.clip_shape(mix["clips"], model)
    clips = traffic.make_clips(seed, mix["clips"], 2, "cpu").to(F64)
    A, FB, TW = (t.to(F64) for t in traffic.make_params(
        seed, mix["init"], 2, 2, F, N, model["nmf_rank"], "cpu"))
    return model, clips, A, FB, TW


def _ref(mix, A, FB, TW, model):
    out = reference.fit(mix, A, FB, TW, model)
    out["ys"] = reference.separate(mix, out["A"], out["FB"], out["TW"],
                                   model)
    out["X"] = reference.stft(mix, model["wlen"], model["hop"])
    return out


def test_reference_is_the_port_in_float64():
    """The port's CPU path in float64 and the reference follow the same
    trajectory to rounding (the loglik to the port's float32 annealing
    weight, a relative 1e-7)."""
    model, mix, A, FB, TW = _inputs()
    got = _port(mix, A, FB, TW, model, F64)
    ref = _ref(mix, A, FB, TW, model)
    assert torch.allclose(got["X"], ref["X"], rtol=0, atol=1e-12)
    gap = (got["logliks"] - ref["logliks"]).abs().amax() \
        / ref["logliks"].abs().amax()
    assert gap < 1e-6
    for name in ("A", "FB", "TW", "ys"):
        assert torch.allclose(got[name], ref[name], rtol=1e-9, atol=1e-12), \
            name


def test_reference_holds_in_float32():
    """In float32 the reference stays close to its float64 run: no step of
    it subtracts large terms."""
    model, mix, A, FB, TW = _inputs()
    ref = _ref(mix, A, FB, TW, model)
    low = _ref(*(t.float() for t in (mix, A, FB, TW)), model)
    rel = (low["ys"].double() - ref["ys"]).norm() / ref["ys"].norm()
    assert rel < 1e-5
    assert ((low["logliks"].double() - ref["logliks"]).abs().amax()
            / ref["logliks"].abs().amax()) < 1e-5


def test_bfloat16_filter_departs():
    """The control's Wiener filter in bfloat16 moves the images by a
    thousandth or more."""
    model, mix, A, FB, TW = _inputs(niter=5)
    ys = reference.separate(mix, A, FB, TW, model)
    low = reference.separate(mix.float(), A.float(), FB.float(), TW.float(),
                             model, low=torch.bfloat16)
    assert (low.double() - ys).norm() / ys.norm() > 1e-3


def test_stft_round_trip():
    x = torch.randn(2, 3001, 2, dtype=F64)
    X = reference.stft(x, 256, 128)
    assert torch.allclose(reference.istft(X, 256, 128, 3001), x, atol=1e-12)


@pytest.mark.parametrize("seed", (0, 123456, 2 ** 31 - 1))
def test_host_init_is_the_host_apis(tmp_path, seed):
    """prng.host_init draws what MultiChanNMFInst_FASST starts from."""
    variants = importlib.import_module("pyfasst_tpu_torch.models.variants")
    path = tmp_path / "clip.wav"
    data = np.random.default_rng(1).standard_normal((4000, 2)) * 0.1
    wav.write_float32(path, data.astype(np.float32), 44100)
    m = variants.MultiChanNMFInst_FASST(str(path), nbComps=2, nbNMFComps=3,
                                        seed=seed, device="cpu")
    A, FB, TW = prng.host_init(seed, m.F, m.N, 2, 3)
    assert np.array_equal(A, np.stack([c.A[0, :, 0].numpy()
                                       for c in m.params.spat]))
    assert np.array_equal(FB, np.stack([c.FB[0].numpy()
                                        for c in m.params.spec]))
    assert np.array_equal(TW, np.stack([c.TW[0].numpy()
                                        for c in m.params.spec]))


def test_wav_round_trip(tmp_path):
    data = np.random.default_rng(2).standard_normal((500, 2)).astype(
        np.float32)
    wav.write_float32(tmp_path / "a.wav", data, 16000)
    got, fs = wav.read(tmp_path / "a.wav")
    assert fs == 16000 and np.array_equal(got, data)
    audio = importlib.import_module("pyfasst_tpu_torch.audio")
    audio.wav_write(tmp_path / "b.wav", data / 4, 16000)
    words, _ = wav.read(tmp_path / "b.wav")
    assert np.array_equal(words, reference.pcm16(
        torch.as_tensor(data[None] / 4, dtype=F64))[0].numpy())
