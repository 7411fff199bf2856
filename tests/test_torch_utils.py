"""The port's small utilities against the JAX package's: metrics (a copy of
its NumPy, so equal numbers), signal helpers on tensors (float64: rtol
1e-12), the NumPy WAV codec (the cases of tests/test_native_wavio.py, held
against scipy and against the native codec's documented conventions),
logging, and the K > MAX_K guard of the fused spectral step.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from pyfasst_tpu.utils import metrics as jmetrics
from pyfasst_tpu.utils import signal as jsignal
from pyfasst_tpu_torch import audio, convert
from pyfasst_tpu_torch.ops import cuda_spectral
from pyfasst_tpu_torch.utils import logging as tlog
from pyfasst_tpu_torch.utils import metrics, signal

torch.set_num_threads(1)


# -- metrics -------------------------------------------------------------------

@pytest.mark.parametrize("fn,L", [("bss_eval_sources", 16),
                                  ("bss_eval_images", 8)])
def test_bss_eval_matches_jax(fn, L):
    rng = np.random.default_rng(0)
    T = 4000
    s = rng.standard_normal((2, T))
    est = np.stack([s[0] + 0.1 * s[1], 0.9 * s[1] + 0.05 * s[0]])
    if fn == "bss_eval_images":
        s = np.stack([s, 0.5 * s[:, ::-1]], axis=-1)       # (J, T, 2)
        est = np.stack([est, 0.5 * est[:, ::-1]], axis=-1)
    got = getattr(metrics, fn)(est[::-1], s, filt_len=L)
    want = getattr(jmetrics, fn)(est[::-1], s, filt_len=L)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got["perm"]) == [1, 0] and np.all(got["sdr"] > 10)


def test_si_sdr_and_xrt():
    t = np.linspace(0, 1, 1000)
    s = np.sin(2 * np.pi * 5 * t)
    noisy = s + 0.01 * np.cos(2 * np.pi * 17 * t)
    assert metrics.si_sdr(noisy, s) == jmetrics.si_sdr(noisy, s)
    assert metrics.si_sdr(2.0 * s, s) > 100
    assert abs(metrics.xrt(10.0, 0.2) - 50.0) < 1e-9
    assert metrics.xrt(10.0, 0.2, n_chips=4) == jmetrics.xrt(10.0, 0.2, 4)


# -- signal --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["median_axis_last", "median_axis0",
                                  "smooth_spectrum", "is_distortion", "db",
                                  "hwps_weight"])
def test_signal_helpers_match_jax(case):
    from jax import enable_x64
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 50))
    P, V = 0.5 + rng.random((10, 12)), 0.5 + rng.random((10, 12))
    freqs = np.linspace(0.0, 2000.0, 101)
    calls = {
        "median_axis_last": lambda m, a: m.median_filter(a(x), 5, axis=-1),
        "median_axis0": lambda m, a: m.median_filter(a(x), 3, axis=0),
        "smooth_spectrum": lambda m, a: m.smooth_spectrum(a(P)),
        "is_distortion": lambda m, a: m.is_distortion(a(P), a(V)),
        "db": lambda m, a: m.db(a(x)),
        "hwps_weight": lambda m, a: m.hwps_weight(a(freqs), 110.0),
    }
    got = calls[case](signal, torch.as_tensor).numpy()
    with enable_x64():
        want = np.asarray(calls[case](jsignal, jnp.asarray))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_median_filter_matches_scipy_and_rejects_even_sizes():
    from scipy.ndimage import median_filter as sp_med
    x = np.random.default_rng(2).standard_normal((7, 50))
    got = signal.median_filter(torch.as_tensor(x), 5, axis=-1).numpy()
    np.testing.assert_array_equal(got, sp_med(x, size=(1, 5), mode="nearest"))
    with pytest.raises(ValueError, match="odd"):
        signal.median_filter(torch.as_tensor(x), 4)


# -- WAV codec -----------------------------------------------------------------

@pytest.fixture
def stereo():
    rng = np.random.default_rng(3)
    return np.clip(0.4 * rng.standard_normal((500, 2)), -1, 1)


def test_pcm16_matches_scipy(tmp_path, stereo):
    p = str(tmp_path / "a.wav")
    wavfile.write(p, 16000, np.round(stereo * 32767).astype(np.int16))
    ours, sr = audio.wav_read(p)
    assert sr == 16000
    np.testing.assert_array_equal(ours, wavfile.read(p)[1] / 32768.0)


@pytest.mark.parametrize("bits,tol", [(16, 2 ** -14), (24, 2 ** -22),
                                      (32, 1e-7)])
def test_write_read_roundtrip(tmp_path, stereo, bits, tol):
    p = str(tmp_path / "b.wav")
    audio.wav_write(p, stereo, 22050, bits=bits)
    y, sr = audio.wav_read(p)
    assert sr == 22050 and y.shape == stereo.shape
    assert np.abs(y - stereo).max() < tol
    info = audio.wav_info(p)
    assert info == {"samplerate": 22050, "channels": 2, "frames": 500,
                    "bits": bits, "format": "float" if bits == 32 else "pcm"}
    sr2, raw = wavfile.read(p) if bits != 24 else (22050, None)
    if bits == 16:        # scipy reads what was written, PCM16 as int16
        np.testing.assert_array_equal(raw, np.rint(stereo * 32767))
    elif bits == 32:
        np.testing.assert_array_equal(raw, stereo.astype(np.float32))


def test_pcm_formats_read_as_scipy_scales_them(tmp_path):
    """u8 and PCM32 files written by scipy: the JAX package's scales."""
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (300, 2)).astype(np.uint8)
    i32 = rng.integers(-2 ** 31, 2 ** 31, (300, 1)).astype(np.int32)
    f64 = rng.standard_normal((300, 3))
    for name, arr, want in (("u8", u8, (u8 - 128.0) / 128.0),
                            ("i32", i32, i32 / 2.0 ** 31),
                            ("f64", f64, f64)):
        p = str(tmp_path / f"{name}.wav")
        wavfile.write(p, 8000, arr)
        np.testing.assert_array_equal(audio.wav_read(p)[0], want)


def test_block_read(tmp_path, stereo):
    p = str(tmp_path / "c.wav")
    audio.wav_write(p, stereo, 8000, bits=32)
    full, _ = audio.wav_read(p)
    blk, _ = audio.wav_read(p, offset=123, frames=77)
    np.testing.assert_array_equal(blk, full[123:200])
    assert audio.wav_read(p, offset=490, frames=100)[0].shape == (10, 2)
    assert audio.wav_read(p, offset=10_000, frames=4)[0].shape == (0, 2)


def test_extra_chunks_and_extensible(tmp_path, stereo):
    """An odd-sized junk chunk before fmt and a WAVE_FORMAT_EXTENSIBLE
    header (the bytes of tests/test_native_wavio.py)."""
    pcm = np.round(stereo * 32767).astype("<i2").tobytes()
    fmt = (np.array([0xFFFE, 2], "<u2").tobytes()
           + np.array([16000, 16000 * 4], "<u4").tobytes()
           + np.array([4, 16, 22, 16], "<u2").tobytes()
           + np.array([4], "<u4").tobytes()
           + np.array([1], "<u2").tobytes() + b"\x00" * 14)
    junk = b"JUNK" + np.array([3], "<u4").tobytes() + b"odd\x00"
    body = (junk + b"fmt " + np.array([len(fmt)], "<u4").tobytes() + fmt
            + b"data" + np.array([len(pcm)], "<u4").tobytes() + pcm)
    blob = b"RIFF" + np.array([4 + len(body)], "<u4").tobytes() + b"WAVE" \
        + body
    p = str(tmp_path / "d.wav")
    with open(p, "wb") as fh:
        fh.write(blob)
    y, sr = audio.wav_read(p)
    assert sr == 16000
    np.testing.assert_allclose(y, np.round(stereo * 32767) / 32768.0)


def test_error_paths(tmp_path):
    with pytest.raises(OSError):
        audio.wav_read(str(tmp_path / "missing.wav"))
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as fh:
        fh.write(b"NOTAWAVFILE" * 8)
    with pytest.raises(ValueError, match="RIFF"):
        audio.wav_read(bad)
    with pytest.raises(ValueError, match="bits"):
        audio.wav_write(bad, np.zeros((4, 1)), 8000, bits=12)
    with pytest.raises(ValueError, match="dtype"):
        audio.AudioObject(data=np.zeros((4, 1)))._write(bad, dtype=np.int32)


def test_corrupt_block_align_ignored(tmp_path, stereo):
    """block_align in the file is never trusted."""
    p = str(tmp_path / "ba.wav")
    audio.wav_write(p, stereo, 16000, bits=16)
    blob = bytearray(open(p, "rb").read())
    assert blob[12:16] == b"fmt " and int.from_bytes(blob[32:34],
                                                     "little") == 4
    for bad in (1, 2, 8, 0xFFFF):
        blob[32:34] = int(bad).to_bytes(2, "little")
        with open(p, "wb") as fh:
            fh.write(blob)
        assert audio.wav_info(p)["frames"] == 500
        y, _ = audio.wav_read(p)
        np.testing.assert_array_equal(
            y, np.round(stereo * 32767).astype(np.int16) / 32768.0)


def test_fuzzed_headers_raise_clean_errors(tmp_path):
    rng = np.random.default_rng(5)
    base = str(tmp_path / "f.wav")
    audio.wav_write(base, np.zeros((64, 2)), 8000, bits=16)
    blob = bytearray(open(base, "rb").read())
    for _ in range(200):
        mutated = bytearray(blob)
        for _ in range(rng.integers(1, 6)):
            mutated[rng.integers(0, min(64, len(mutated)))] = \
                int(rng.integers(0, 256))
        if rng.random() < 0.3:
            mutated = mutated[:rng.integers(0, len(mutated))]
        p = str(tmp_path / "m.wav")
        with open(p, "wb") as fh:
            fh.write(mutated)
        try:
            audio.wav_read(p)
            audio.wav_info(p)
        except (ValueError, OSError):
            pass


def test_audioobject_convention(tmp_path, stereo):
    """AudioObject, wavread, wavwrite and wavread_block as the JAX
    package's: PCM16 written at 32767, read at 32768."""
    p = str(tmp_path / "e.wav")
    audio.wavwrite(stereo, 16000, p)
    obj = audio.AudioObject(p)
    assert obj.samplerate == 16000 and obj.channels == 2
    assert np.abs(obj.data - stereo).max() < 2 ** -14
    np.testing.assert_array_equal(
        obj.data, np.round(np.clip(stereo, -1, 1) * 32767) / 32768.0)
    data, sr = audio.wavread(p)
    np.testing.assert_array_equal(data, obj.data)
    blk, _ = audio.wavread_block(p, 50, 25)
    np.testing.assert_array_equal(blk, data[50:75])
    q = str(tmp_path / "f.wav")
    audio.AudioObject(data=stereo, samplerate=8000)._write(q,
                                                          dtype=np.float32)
    np.testing.assert_array_equal(audio.AudioObject(q).data,
                                  stereo.astype(np.float32))


# -- logging -------------------------------------------------------------------

def test_logging_records(tmp_path):
    sink = tlog.JSONLWriter(str(tmp_path / "logs" / "run.jsonl"))
    with tlog.phase_timer("gem", sink, clips=2):
        pass
    with tlog.device_trace(None):
        pass
    with tlog.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert list((tmp_path / "trace").iterdir())
    rec = tlog.gem_metrics_record([1.0, 2.0, 1.5], 2.0, 10.0, 3, cell="x")
    assert rec["xrt"] == 5.0 and rec["loglik_monotone_frac"] == 0.5
    sink.write(rec)
    lines = [json.loads(ln) for ln in
             open(tmp_path / "logs" / "run.jsonl").read().splitlines()]
    assert lines[0]["phase"] == "gem" and lines[0]["clips"] == 2
    assert lines[1]["cell"] == "x"


# -- fused spectral guard ------------------------------------------------------

@pytest.mark.parametrize("K,eligible", [(32, True), (33, False)])
def test_fused_spectral_is_eligible_up_to_max_k(K, eligible):
    """K > MAX_K takes the plain update_spectral instead of raising in the
    kernel wrappers."""
    rng = np.random.default_rng(6)
    tree = {"spat": [{"A": np.ones((2, 1)), "mix_type": "inst"}] * 2,
            "spec": [{"FB": rng.random((9, K)), "TW": rng.random((K, 5)),
                      "spat_ind": j} for j in range(2)]}
    assert cuda_spectral.eligible(convert.params_from_numpy(tree)) is \
        eligible
