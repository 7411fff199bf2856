"""Streaming separation on the port against the JAX package: the block
STFT and its synthesis (tf/stft.py), separate_streaming end to end
(models/streaming.py) and its checkpoints, on the CPU.

Fixture: tests/test_online.py's dense-band stereo mixture, 16 s at 8 kHz,
wlen 512, blocks of 32 frames, J = 2, K = 6 (15 blocks per pass). Bars:
- blocks: bit for bit against the port's own computeTransform; within
  2e-6 of the peak against the JAX package's blocks (test_torch_stft.py's
  STFT bar);
- synthesis: the port's istft within 1e-6 of the peak, the JAX package's
  StreamingSynthesis within 2e-6 (its own test holds it to istft at 1e-5);
- end to end: images within 5e-4 of their peak (test_torch_model.py's
  bar; measured 1.4e-6 random, 6.5e-7 blind), block logliks rtol 1e-4,
  the blind init's directions within 1e-4; SDR > 3 dB and conservation
  < 0.05, as the JAX package's test;
- resume: the port's resumed run equals its uninterrupted run bit for bit;
  a checkpoint written by either package resumes in the other to the
  end-to-end bars above.
The JAX package's stream_blocks and separate_streaming are called with its
native WAV codec switched off for the call (the scipy path), so no test
here builds pyfasst_tpu/native/_wavio.
"""
import contextlib
import inspect
import os

import numpy as np
import pytest
import torch

import pyfasst_tpu.native
from pyfasst_tpu.models import streaming as jstreaming
from pyfasst_tpu.tf.stft import STFT as JSTFT
from pyfasst_tpu_torch.audio import wav_read, wavwrite
from pyfasst_tpu_torch.models import streaming
from pyfasst_tpu_torch.ops import online
from pyfasst_tpu_torch.tf.stft import STFT

torch.set_num_threads(1)

FS = 8000
KW = dict(J=2, K=6, wlen=512, frames_per_block=32, verbose=0)
IMG_TOL = 5e-4
LL_RTOL = 1e-4


@pytest.fixture
def no_native(monkeypatch):
    """The JAX package's WAV reads through its scipy path for this test."""
    monkeypatch.setattr(pyfasst_tpu.native, "_wavio_tried", True)
    monkeypatch.setattr(pyfasst_tpu.native, "_wavio_mod", None)


@contextlib.contextmanager
def _no_native_ctx():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyfasst_tpu.native, "_wavio_tried", True)
        mp.setattr(pyfasst_tpu.native, "_wavio_mod", None)
        yield


def _dense_band_mixture(path, seconds, seed=0):
    """tests/test_online.py's fixture: two band-limited noises panned
    apart. Returns (mix (n, 2), true images (2, n, 2)), both scaled."""
    from scipy.signal import butter, lfilter
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)

    def band(lo, hi):
        b, a = butter(4, [lo, hi], btype="band")
        s = lfilter(b, a, rng.standard_normal(n))
        return s / (np.std(s) + 1e-9)

    s1, s2 = band(0.02, 0.3), band(0.25, 0.8)
    A = np.array([[0.95, 0.31], [0.31, 0.95]])
    ys_true = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    mix = ys_true.sum(0)
    sc = np.max(np.abs(mix)) * 1.05
    wavwrite(mix / sc, FS, path)
    return mix / sc, ys_true / sc


@pytest.fixture(scope="module")
def fixture16(tmp_path_factory):
    """The 16 s WAV, both packages' random and blind runs of it, and what
    each package's blind prefix init returned."""
    d = tmp_path_factory.mktemp("stream")
    path = str(d / "long.wav")
    mix, ys_true = _dense_band_mixture(path, 16.0)
    runs, inits = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in (("jax", jstreaming), ("torch", streaming)):
            def record(*a, _name=name, _real=mod._blind_prefix_init):
                inits[_name] = _real(*a)
                return inits[_name]
            mp.setattr(mod, "_blind_prefix_init", record)
        for init in ("random", "blind"):
            kw = dict(KW, init=init, init_seconds=2.0)
            with _no_native_ctx():
                runs["jax", init] = jstreaming.separate_streaming(path, **kw)
            runs["torch", init] = streaming.separate_streaming(
                path, device="cpu", out_dir=str(d / f"out_{init}"), **kw)
    return path, mix, ys_true, runs, inits


def _sdr(a, b):
    return 10 * np.log10(np.sum(b ** 2) / max(np.sum((a - b) ** 2), 1e-12))


def _best_min_sdr(ys, ys_true):
    return max(min(_sdr(ys[0], ys_true[0]), _sdr(ys[1], ys_true[1])),
               min(_sdr(ys[1], ys_true[0]), _sdr(ys[0], ys_true[1])))


def _images_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= IMG_TOL, f"images {err:.3e} of the peak"


@pytest.mark.parametrize("channels", [2, 1])
def test_stream_blocks_equal_the_whole_transform(tmp_path, no_native,
                                                 channels):
    rng = np.random.default_rng(channels)
    x = 0.2 * rng.standard_normal((3 * FS + 17, channels))
    path = str(tmp_path / "x.wav")
    wavwrite(x, FS, path)
    data = wav_read(path)[0].astype(np.float32)
    st = STFT(wlen=512, fs=FS, device="cpu")
    whole = st.computeTransform(data)
    blocks = list(st.stream_blocks(path, 16))
    assert [b.shape[1] for b in blocks] == [16] * 5 + [15]
    assert torch.equal(torch.cat(blocks, dim=1), whole)
    assert torch.equal(torch.cat(list(st.stream_blocks(path, 16,
                                                       start_block=2)),
                                 dim=1), whole[:, 32:])
    jblocks = np.concatenate([np.asarray(b) for b in
                              JSTFT(wlen=512, fs=FS).stream_blocks(path, 16)],
                             axis=1)
    assert jblocks.shape == tuple(whole.shape)
    got = torch.cat(blocks, dim=1).numpy()
    assert np.max(np.abs(got - jblocks)) < 2e-6 * np.max(np.abs(jblocks))


@pytest.mark.parametrize("shape,bs", [((4001, 2), 7), ((3000,), 16)])
def test_streaming_synthesis_matches_istft_and_jax(shape, bs):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    n = shape[0]
    st = STFT(wlen=256, fs=FS, device="cpu")
    X = st.computeTransform(x)
    ref = st.invertTransform(X, nsamples=n).numpy()

    def stream(syn, push):
        outs = [push(syn, m0) for m0 in range(0, X.shape[1], bs)]
        outs.append(syn.flush())
        return np.concatenate([o for o in outs if o.size], axis=0)

    y = stream(st.synthesis_stream(n), lambda s, m0: s.push(X[:, m0:m0 + bs]))
    Xn = X.numpy()
    yj = stream(JSTFT(wlen=256, fs=FS).synthesis_stream(n),
                lambda s, m0: s.push(Xn[:, m0:m0 + bs]))
    assert y.shape == ref.shape == yj.shape and y.dtype == np.float32
    peak = np.max(np.abs(ref))
    assert np.max(np.abs(y - ref)) <= 1e-6 * peak
    assert np.max(np.abs(y - yj)) <= 2e-6 * peak
    assert np.max(np.abs(y - x)) <= 1e-5 * np.max(np.abs(x))
    syn = st.synthesis_stream(n)
    syn.push(X[:, :bs])
    with pytest.raises(ValueError, match="frames"):
        syn.flush()


@pytest.mark.parametrize("init", ["random", "blind"])
def test_separate_streaming_matches_jax(fixture16, init):
    _, _, _, runs, _ = fixture16
    yj, ij = runs["jax", init]
    yt, it = runs["torch", init]
    _images_close(yt, yj)
    assert it["blocks"] == ij["blocks"] == 15
    assert it["resumed_at"] == ij["resumed_at"] == 0
    assert (it["fs"], it["nsamples"], it["block_frames"],
            it["spatial_rank"]) == (ij["fs"], ij["nsamples"],
                                    ij["block_frames"], ij["spatial_rank"])
    np.testing.assert_allclose(it["logliks"], ij["logliks"], rtol=LL_RTOL)
    assert set(it["seconds"]) == {"init", "pass1", "pass2"}


@pytest.mark.parametrize("init", ["random", "blind"])
def test_separate_streaming_separates_and_writes(fixture16, init):
    _, mix, ys_true, runs, _ = fixture16
    ys, info = runs["torch", init]
    assert ys.shape == (2, 16 * FS, 2) and np.all(np.isfinite(ys))
    assert _best_min_sdr(ys, ys_true) > 3.0
    assert np.max(np.abs(ys.sum(0) - mix)) < 0.05
    assert len(info["files"]) == 2
    for j, p in enumerate(info["files"]):
        data, fs = wav_read(p)
        assert fs == FS and data.shape == (16 * FS, 2)
        # PCM16 steps; the writer clips at full scale
        assert np.max(np.abs(data - np.clip(ys[j], -1.0, 1.0))) < 1e-4


def test_blind_init_picks_the_jax_directions(fixture16):
    """DEMIX on the 2 s prefix chooses the same directions in both
    packages (the decision, not only the floats)."""
    inits = fixture16[4]
    jA, jFB, jvalid = inits["jax"]
    tA, tFB, tvalid = inits["torch"]
    assert jFB is None and tFB is None
    np.testing.assert_array_equal(tvalid, jvalid)
    assert tA.shape == np.asarray(jA).shape == (2, 257, 2)
    assert np.max(np.abs(tA - np.asarray(jA))) < 1e-4


def test_separate_streaming_rejects_bad_settings(fixture16):
    path = fixture16[0]
    with pytest.raises(ValueError, match="init"):
        streaming.separate_streaming(path, init="bogus", device="cpu", **KW)
    with pytest.raises(ValueError, match="spatial_rank"):
        streaming.separate_streaming(path, spatial_rank=3, device="cpu",
                                     **KW)


def test_separate_streaming_resumes_bit_for_bit(fixture16, tmp_path):
    path, _, _, runs, _ = fixture16
    ys_c, info_c = runs["torch", "random"]
    ck = str(tmp_path / "ck.npz")
    _, info_i = streaming.separate_streaming(
        path, checkpoint_path=ck, checkpoint_every=5, estimate_blocks=5,
        device="cpu", **KW)
    assert os.path.exists(ck) and info_i["blocks"] == 5
    ys_r, info_r = streaming.separate_streaming(
        path, checkpoint_path=ck, checkpoint_every=5, device="cpu", **KW)
    assert info_r["resumed_at"] == 5 and info_r["blocks"] == 15
    assert info_r["logliks"] == info_c["logliks"]
    assert np.array_equal(ys_r, ys_c)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stream_checkpoint_resumes_in_the_other_package(fixture16, tmp_path,
                                                        writer):
    path, _, _, runs, _ = fixture16
    ck = str(tmp_path / "ck.npz")
    cut = dict(checkpoint_path=ck, checkpoint_every=5, estimate_blocks=5)
    with _no_native_ctx():
        if writer == "jax":
            jstreaming.separate_streaming(path, **cut, **KW)
            ys, info = streaming.separate_streaming(
                path, checkpoint_path=ck, device="cpu", **KW)
            want = runs["torch", "random"]
        else:
            streaming.separate_streaming(path, device="cpu", **cut, **KW)
            ys, info = jstreaming.separate_streaming(
                path, checkpoint_path=ck, **KW)
            want = runs["jax", "random"]
    assert info["resumed_at"] == 5 and info["blocks"] == 15
    np.testing.assert_allclose(info["logliks"], want[1]["logliks"],
                               rtol=LL_RTOL)
    _images_close(np.asarray(ys), want[0])


def test_stream_checkpoint_refuses_other_settings(fixture16, tmp_path):
    path = fixture16[0]
    ck = str(tmp_path / "ck.npz")
    streaming.separate_streaming(path, checkpoint_path=ck,
                                 checkpoint_every=2, estimate_blocks=2,
                                 device="cpu", **KW)
    with pytest.raises(ValueError, match=r"seed: checkpoint=0 run=1; "
                                         r"forgetting: checkpoint=0\.95 "
                                         r"run=0\.9"):
        streaming.separate_streaming(path, checkpoint_path=ck,
                                     forgetting=0.9, seed=1, device="cpu",
                                     **KW)
    with np.load(ck) as z:
        arrays = {k: z[k] for k in z.files if k != "config_json"}
    np.savez(ck, **arrays)
    with pytest.raises(ValueError, match="predates configuration"):
        streaming.separate_streaming(path, checkpoint_path=ck, device="cpu",
                                     **KW)


def test_stream_checkpoint_layout_is_the_jax_one(fixture16, tmp_path):
    """No clip axis, complex leaves complex, as the JAX package writes."""
    path = fixture16[0]
    ck = str(tmp_path / "ck.npz")
    streaming.separate_streaming(path, checkpoint_path=ck,
                                 checkpoint_every=1, estimate_blocks=1,
                                 device="cpu", **KW)
    with np.load(ck) as z:
        assert z["A"].shape == (2, 257, 2) and z["A"].dtype == np.complex64
        assert z["tss"].shape == (2, 2, 257) and z["t4"].dtype == np.float32
        assert z["sigma"].shape == (257,) and int(z["next_block"]) == 1
        assert z["lls"].shape == (1,)


def test_nonfinite_block_loglik_raises(fixture16, monkeypatch):
    """Pass 1 checks the block logliks once, at its end, and names the
    first non-finite block."""
    real = online.online_block

    def bad(state, Xb, *a, **kw):
        state, (TWb, ll) = real(state, Xb, *a, **kw)
        return state, (TWb, ll * float("nan"))

    monkeypatch.setattr(online, "online_block", bad)
    with pytest.raises(RuntimeError, match="non-finite.*block 0"):
        streaming.separate_streaming(fixture16[0], device="cpu", **KW)


def test_separate_streaming_defaults_to_the_card(fixture16, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sig = inspect.signature(streaming.separate_streaming)
    assert sig.parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.separate_streaming(fixture16[0], **KW)
