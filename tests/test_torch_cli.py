"""The port's CLI (`python -m pyfasst_tpu_torch`) end to end on tiny clips.

tests/test_cli.py's cases on the port with `--device cpu`, on the same
1 s, 8 kHz stereo fixture, plus the branches and refusals the port adds:
the mono blind init, the DEMIX init, the MinQT front-end, the device
choice and the multi-device refusal. Parity with the JAX package's CLI is
in tests/test_torch_cli_parity.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from pyfasst_tpu_torch.__main__ import main
from pyfasst_tpu_torch.audio import wav_info, wavread, wavwrite

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture
def mix_wav(tmp_path, rng):
    fs = 8000
    t = np.arange(fs) / fs
    s1 = 0.5 * np.sin(2 * np.pi * 440 * t)
    s2 = 0.3 * rng.standard_normal(fs)
    mix = np.stack([0.9 * s1 + 0.3 * s2, 0.3 * s1 + 0.9 * s2], 1)
    p = str(tmp_path / "mix.wav")
    wavwrite(mix, fs, p)
    return p


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _separate(argv, capsys, n_files=2):
    """Run `separate` on the CPU; check the report's files and loglik."""
    assert main(["separate"] + argv + ["-q"] + CPU) == 0
    rep = _last_json(capsys)
    assert len(rep["files"]) == n_files
    for f in rep["files"]:
        assert os.path.exists(f)
    assert np.isfinite(rep["final_loglik"])
    return rep


def test_info(mix_wav, capsys):
    assert main(["info", mix_wav]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"samplerate": 8000, "channels": 2, "frames": 8000,
                   "bits": 16, "format": "pcm"}


def test_separate_inst(mix_wav, tmp_path, capsys):
    rep = _separate([mix_wav, "-o", str(tmp_path / "sep"), "--iters", "8",
                     "--nmf-comps", "3", "--wlen", "256"], capsys)
    assert rep["iterations"] == 8
    assert set(rep) == {"files", "iterations", "final_loglik",
                        "wall_seconds", "xrt"}


@pytest.mark.parametrize("front_end", ["erblet", "cqlet", "minqt"])
def test_separate_warped_transform(mix_wav, tmp_path, capsys, front_end):
    bands = "12" if front_end == "minqt" else "24"
    _separate([mix_wav, "-o", str(tmp_path / "sep"), "--iters", "8",
               "--nmf-comps", "3", "--transform", front_end, "--tf-bands",
               bands, "--wlen", "256"], capsys)


def test_separate_streaming_cli(mix_wav, tmp_path, capsys):
    rep = _separate([mix_wav, "-o", str(tmp_path / "stream"), "--streaming",
                     "--block-frames", "16", "--wlen", "256",
                     "--nmf-comps", "3"], capsys)
    assert rep["blocks"] >= 2


def test_separate_streaming_cli_rejects_warped(mix_wav, capsys):
    assert main(["separate", mix_wav, "--streaming", "--transform",
                 "erblet", "-q"] + CPU) == 2
    assert "STFT front-end" in capsys.readouterr().err


def test_separate_streaming_cli_fullrank(mix_wav, tmp_path, capsys):
    """`--streaming --model fullrank` drives the online Duong path."""
    rep = _separate([mix_wav, "-o", str(tmp_path / "stream_fr"),
                     "--streaming", "--model", "fullrank", "--block-frames",
                     "16", "--wlen", "256", "--nmf-comps", "3"], capsys)
    assert rep["blocks"] >= 2


def test_separate_streaming_cli_rejects_other_models(mix_wav, capsys):
    assert main(["separate", mix_wav, "--streaming", "--model", "hmm",
                 "-q"] + CPU) == 2
    assert "fullrank" in capsys.readouterr().err


def test_separate_checkpoint(mix_wav, tmp_path, capsys):
    from pyfasst_tpu_torch.utils.checkpoint import load_params
    ck = str(tmp_path / "ck.npz")
    _separate([mix_wav, "-o", str(tmp_path / "s"), "--iters", "4",
               "--wlen", "256", "--checkpoint", ck], capsys)
    _, it, _ = load_params(ck, device="cpu")
    assert it == 4


def test_separate_resume_round_trip(mix_wav, tmp_path, capsys):
    """--checkpoint-every cuts a run into chunks; a --resume of its final
    checkpoint runs zero iterations (final_loglik null) and writes the
    same separation."""
    ck = str(tmp_path / "ck.npz")
    base = [mix_wav, "--iters", "6", "--nmf-comps", "3", "--wlen", "256",
            "-q"] + CPU
    assert main(["separate", "-o", str(tmp_path / "a"), "--checkpoint", ck,
                 "--checkpoint-every", "3"] + base) == 0
    full = _last_json(capsys)
    assert main(["separate", "-o", str(tmp_path / "b"), "--resume",
                 ck] + base) == 0
    rep = _last_json(capsys)
    assert rep["final_loglik"] is None
    assert np.isfinite(full["final_loglik"])
    for a, b in zip(full["files"], rep["files"]):
        assert np.array_equal(wavread(a)[0], wavread(b)[0])


def test_demix_command(mix_wav, capsys):
    assert main(["demix", mix_wav, "--sources", "2", "--wlen", "256"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["sources"] == 2 and len(out["gains"]) == 2
    assert len(out["delays_samples"]) == 2


def test_lead_command(mix_wav, tmp_path, capsys):
    assert main(["lead", mix_wav, "-o", str(tmp_path / "l"), "--iters", "4",
                 "--wlen", "256", "--n-f0", "24"] + CPU) == 0
    rep = json.loads(capsys.readouterr().out)
    assert len(rep["files"]) == 2 and rep["melody_frames"] > 0
    for f in rep["files"]:
        assert os.path.exists(f)


def test_separate_batch_directory(tmp_path, rng, capsys):
    """`separate --batch dir/` separates variable-length clips through the
    bucketed batch path, each cropped back to its own length."""
    fs = 8000
    clip_dir = tmp_path / "clips"
    clip_dir.mkdir()
    durs = (("a", 0.6), ("b", 1.0), ("c", 1.4))
    for name, dur in durs:
        t = np.arange(int(fs * dur)) / fs
        s1 = 0.5 * np.sin(2 * np.pi * 440 * t)
        s2 = 0.3 * rng.standard_normal(len(t))
        mix = np.stack([0.9 * s1 + 0.3 * s2, 0.3 * s1 + 0.9 * s2], 1)
        wavwrite(mix, fs, str(clip_dir / f"{name}.wav"))
    assert main(["separate", str(clip_dir), "--batch", "-o",
                 str(tmp_path / "sep"), "--iters", "6", "--nmf-comps", "3",
                 "--wlen", "256", "-q"] + CPU) == 0
    rep = _last_json(capsys)
    assert rep["clips"] == 3
    for stem, dur in durs:
        files = rep["results"][stem]["files"]
        assert len(files) == 2 and all(os.path.exists(f) for f in files)
        assert np.isfinite(rep["results"][stem]["final_loglik"])
        assert wavread(files[0])[0].shape[0] == int(fs * dur)


def test_batch_rejects_warped_transform(tmp_path, capsys):
    d = tmp_path / "clips"
    d.mkdir()
    assert main(["separate", str(d), "--batch", "--transform",
                 "erblet"] + CPU) == 2
    assert "STFT front-end" in capsys.readouterr().err


def test_missing_file_is_clean_error(capsys):
    assert main(["separate", "no_such_file.wav", "-q"] + CPU) == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("model", ["hmm", "gsmm"])
def test_separate_hmm_and_gsmm(mix_wav, tmp_path, capsys, model):
    _separate([mix_wav, "-o", str(tmp_path / model), "--model", model,
               "--states", "3", "--iters", "6", "--wlen", "256"], capsys)


def test_separate_hmm_viterbi(mix_wav, tmp_path, capsys):
    _separate([mix_wav, "-o", str(tmp_path / "v"), "--model", "hmm",
               "--decode", "viterbi", "--states", "3", "--iters", "4",
               "--wlen", "256"], capsys)


def test_separate_fullrank_erb(mix_wav, tmp_path, capsys):
    _separate([mix_wav, "-o", str(tmp_path / "fr"), "--model", "fullrank",
               "--freq-basis", "erb", "--bands", "12", "--iters", "6",
               "--wlen", "256"], capsys)


def test_separate_conv_demix(mix_wav, tmp_path, capsys):
    """--demix seeds the convolutive mixing from the DEMIX directions."""
    _separate([mix_wav, "-o", str(tmp_path / "dm"), "--model", "conv",
               "--demix", "--iters", "6", "--nmf-comps", "3", "--wlen",
               "256"], capsys)


def test_separate_fullrank_spatial_init(mix_wav, tmp_path, capsys):
    _separate([mix_wav, "-o", str(tmp_path / "si"), "--model", "fullrank",
               "--spatial-init", "--iters", "6", "--nmf-comps", "3",
               "--wlen", "256"], capsys)


def test_separate_fullrank_spatial_init_over_erblet(mix_wav, tmp_path,
                                                    capsys):
    """The spatial-cluster init on the erblet coefficients; the engine
    separates in that domain."""
    _separate([mix_wav, "-o", str(tmp_path / "sep"), "--model", "fullrank",
               "--spatial-init", "--transform", "erblet", "--tf-bands",
               "24", "--iters", "8", "--nmf-comps", "3"], capsys)


def test_separate_mono_spatial_init(tmp_path, rng, capsys):
    """A one-channel WAV under --spatial-init takes the blind mono init."""
    fs = 8000
    t = np.arange(fs) / fs
    x = 0.4 * np.sin(2 * np.pi * 440 * t) \
        + 0.2 * rng.standard_normal(fs) * (np.sin(2 * np.pi * 2 * t) > 0)
    p = str(tmp_path / "mono.wav")
    wavwrite(x[:, None], fs, p)
    rep = _separate([p, "-o", str(tmp_path / "m"), "--spatial-init",
                     "--iters", "6", "--nmf-comps", "3", "--wlen", "256"],
                    capsys)
    assert rep["init"] == "mono-nmf-cluster"


def test_separate_reseed_pipeline(mix_wav, tmp_path, capsys):
    """--spatial-init --reseed N runs the blind reverberant pipeline."""
    rep = _separate([mix_wav, "-o", str(tmp_path / "rp"), "--model",
                     "fullrank", "--spatial-init", "--reseed", "1",
                     "--iters", "8", "--nmf-comps", "3", "--wlen", "256"],
                    capsys)
    assert rep["stages"] and isinstance(rep["picked"], str)
    assert rep["stages"][-1] == rep["picked"]


def test_separate_reseed_pipeline_guarded(mix_wav, tmp_path, capsys):
    """--select consistency --reseed-select envcorr: consistency pool
    selection with envcorr-guarded reseed acceptance."""
    _separate([mix_wav, "-o", str(tmp_path / "rg"), "--model", "fullrank",
               "--spatial-init", "--reseed", "1", "--iters", "8",
               "--nmf-comps", "3", "--wlen", "256", "--select",
               "consistency", "--reseed-select", "envcorr"], capsys)


def test_separate_multiscale_ladder(mix_wav, tmp_path, capsys):
    """--multiscale-wlen W runs the fine->coarse ladder; W must be finer
    than --wlen."""
    rep = _separate([mix_wav, "-o", str(tmp_path / "ms"), "--model",
                     "fullrank", "--spatial-init", "--reseed", "1",
                     "--multiscale-wlen", "64", "--iters", "8",
                     "--nmf-comps", "3", "--wlen", "256"], capsys)
    assert rep["picked"].split("|")[0].startswith(("ladder", "reseed"))
    assert main(["separate", mix_wav, "-o", str(tmp_path / "y"), "--model",
                 "fullrank", "--spatial-init", "--reseed", "1",
                 "--multiscale-wlen", "256", "--wlen", "256", "--iters",
                 "4", "-q"] + CPU) == 2
    assert "finer" in capsys.readouterr().err


def test_reseed_pipeline_over_warped_transform(mix_wav, tmp_path, capsys):
    """The flat reseed pipeline runs on any front-end's plane; only the
    multiscale ladder requires the STFT front-end."""
    _separate([mix_wav, "-o", str(tmp_path / "x"), "--model", "fullrank",
               "--spatial-init", "--reseed", "1", "--transform", "erblet",
               "--tf-bands", "16", "--iters", "4", "--nmf-comps", "3"],
              capsys)
    assert main(["separate", mix_wav, "-o", str(tmp_path / "y"), "--model",
                 "fullrank", "--spatial-init", "--reseed", "1",
                 "--multiscale-wlen", "256", "--transform", "erblet",
                 "--iters", "4", "-q"] + CPU) == 2
    assert "STFT front-end" in capsys.readouterr().err


def test_eval_command(mix_wav, tmp_path, capsys):
    """Scoring swapped estimates: the permutation is recovered and the
    gain/shift lie within the allowed-distortion filters."""
    data, sr = wavread(mix_wav)
    a = str(tmp_path / "a.wav")
    b = str(tmp_path / "b.wav")
    wavwrite(data * 0.8, sr, a)
    wavwrite(np.roll(data, 1, axis=0) * 0.5 + 0.01 * data, sr, b)
    assert main(["eval", "-e", b, a, "-r", a, b]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["permutation"] == [1, 0]
    assert all(s > 20 for s in rep["sdr_db"])


def test_eval_count_mismatch_is_clean(mix_wav, capsys):
    assert main(["eval", "-e", mix_wav, "-r", mix_wav, mix_wav]) == 2
    assert "estimates vs" in capsys.readouterr().err


@pytest.mark.parametrize("command", [["separate"], ["separate", "--batch"],
                                     ["separate", "--streaming"], ["lead"]])
def test_cuda_without_card_exits_2(mix_wav, tmp_path, capsys, monkeypatch,
                                   command):
    """The default device is the card: without one every command that
    builds a model exits with code 2 and resolve_device's message, before
    any work (no output written), never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = str(tmp_path) if "--batch" in command else mix_wav
    out = str(tmp_path / "out")
    for extra in ([], ["--device", "cuda"]):
        assert main(command[:1] + [audio, "-o", out, "-q"] + command[1:]
                    + extra) == 2
        assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_n_devices_refused(mix_wav, tmp_path, capsys):
    """--n-devices 2 without a launcher (no torch.distributed group) exits
    with code 2 and says how to launch it."""
    for extra in (["--reseed", "0"], []):
        assert main(["separate", mix_wav, "-o", str(tmp_path / "n"),
                     "--model", "fullrank", "--spatial-init", "--n-devices",
                     "2", "--iters", "2", "--wlen", "256", "-q"] + extra
                    + CPU) == 2
        assert "torchrun --nproc-per-node 2" in capsys.readouterr().err


@pytest.mark.parametrize("mode", (
    ["--model", "inst"], ["--model", "hmm"], ["--model", "fullrank"],
    ["--streaming"], ["--streaming", "--model", "fullrank",
                      "--spatial-init"]))
def test_n_devices_refused_where_nothing_is_sharded(mix_wav, tmp_path,
                                                    capsys, mode):
    """--n-devices 2 in a mode with no pool or bucket to shard exits with
    code 2 before any work (under a launcher every rank would run the
    same fit and write the same files)."""
    out = tmp_path / "n"
    assert main(["separate", mix_wav, "-o", str(out), "--n-devices", "2",
                 "--iters", "2", "--wlen", "256", "-q"] + mode + CPU) == 2
    assert "shards only --spatial-init" in capsys.readouterr().err
    assert not out.exists()


def test_info_reads_float_and_pcm24(tmp_path, capsys):
    """info prints the header's five fields for the codec's other
    formats."""
    from pyfasst_tpu_torch.audio import wav_write
    x = np.linspace(-0.5, 0.5, 300).reshape(100, 3)
    for bits, fmt in ((32, "float"), (24, "pcm")):
        p = str(tmp_path / f"x{bits}.wav")
        wav_write(p, x, 22050, bits=bits)
        assert main(["info", p]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out == wav_info(p) == {"samplerate": 22050, "channels": 3,
                                      "frames": 100, "bits": bits,
                                      "format": fmt}
