"""The port's CLI against the JAX package's (`pyfasst_tpu/__main__.py`).

The parser (every subcommand and option, with its default, choices and
metavar; the port adds only `--device` and `separate --trace-dir`), the
presets, and the same JSON from `info`, `demix` and `eval` on the same
WAVs (DEMIX's gains and delays within 1e-3: the two packages' STFTs
differ in float32 rounding; BSS-Eval figures within 0.01 dB).
Checkpoints cross both ways: the JAX CLI's 8-iteration `--checkpoint`
resumed by the port's CLI, the port's read by the JAX package. The port's
`separate` report equals its API called with the same arguments, bit for
bit. The JAX package's native WAV codec is switched off for these calls,
so two test workers never race to build it.
"""
import argparse
import json

import numpy as np
import pytest
import torch

import pyfasst_tpu.native
from pyfasst_tpu.__main__ import _PRESETS as J_PRESETS
from pyfasst_tpu.__main__ import build_parser as j_build_parser
from pyfasst_tpu.__main__ import main as j_main
from pyfasst_tpu_torch.__main__ import _PRESETS, _apply_preset, build_parser
from pyfasst_tpu_torch.__main__ import main
from pyfasst_tpu_torch.audio import wavread, wavwrite

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def no_native_codec(monkeypatch):
    monkeypatch.setattr(pyfasst_tpu.native, "_wavio_tried", True)
    monkeypatch.setattr(pyfasst_tpu.native, "_wavio_mod", None)


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


def _subparsers(parser):
    act = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return act.choices


def _options(sub):
    """{dest: (option strings, default, choices, metavar, nargs, required,
    type name)} of a subparser's arguments."""
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.metavar,
                     a.nargs, a.required, getattr(a.type, "__name__", None))
            for a in sub._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["separate", "lead", "demix", "eval",
                                     "info"])
def test_parser_matches_jax(command):
    """Every option of the JAX CLI's subcommand exists in the port's with
    the same strings, default, choices, metavar, nargs and type; the port
    adds `--device` (default cuda) to the commands that build a model, and
    `--trace-dir` (default none) to `separate`, and nothing else; the
    subcommands' own defaults (lead's wlen and iters) agree."""
    want = _subparsers(j_build_parser())[command]
    got = _subparsers(build_parser())[command]
    assert set(_subparsers(build_parser())) == set(
        _subparsers(j_build_parser()))
    w, g = _options(want), _options(got)
    extra = set(g) - set(w)
    if command in ("separate", "lead"):
        assert extra == ({"device", "trace_dir"} if command == "separate"
                         else {"device"})
        assert g["device"][:3] == (("--device",), "cuda", ("cuda", "cpu"))
        if command == "separate":
            assert g["trace_dir"][:2] == (("--trace-dir",), None)
    else:
        assert not extra
    for dest, spec in w.items():
        assert g[dest] == spec, dest
    assert {k: v for k, v in got._defaults.items() if k != "fn"} == \
        {k: v for k, v in want._defaults.items() if k != "fn"}


def test_presets_equal_jax():
    assert _PRESETS == J_PRESETS


def test_preset_applies_operating_point():
    """--preset overwrites the listed knobs wholesale (the JAX package's
    test, on the port)."""
    ns = argparse.Namespace(preset="speech", model="inst", wlen=1024,
                            iters=200, multiscale_wlen=None,
                            spatial_init=False, reseed=-1, nmf_comps=8)
    _apply_preset(ns)
    assert ns.model == "fullrank" and ns.spatial_init and ns.reseed >= 0
    assert ns.select == "learned" and ns.band_em and ns.learned
    assert ns.wlen == 2048 and ns.iters == 400
    for name, cfg in _PRESETS.items():
        assert cfg["model"] == "fullrank" and cfg["spatial_init"], name
        assert cfg["reseed"] >= 0, name
    args = build_parser().parse_args(["separate", "x.wav", "--preset",
                                      "music"])
    _apply_preset(args)
    assert (args.wlen, args.multiscale_wlen, args.reseed) == (8192, 2048, 2)


def test_info_matches_jax(mix_wav, capsys):
    """The JAX CLI without its native codec prints three of the header's
    fields; the port prints those and the native codec's other two."""
    assert j_main(["info", mix_wav]) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(["info", mix_wav]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(want) == {"samplerate", "channels", "frames"}
    assert {k: got[k] for k in want} == want
    assert (got["bits"], got["format"]) == (16, "pcm")


def test_demix_matches_jax(mix_wav, capsys):
    for extra in (["--sources", "2"], []):
        argv = ["demix", mix_wav, "--wlen", "256"] + extra
        assert j_main(argv) == 0
        want = json.loads(capsys.readouterr().out)
        assert main(argv) == 0
        got = json.loads(capsys.readouterr().out)
        assert got["sources"] == want["sources"]
        for key in ("gains", "delays_samples"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-3)


def test_eval_matches_jax(mix_wav, tmp_path, capsys):
    data, sr = wavread(mix_wav)
    rng = np.random.default_rng(3)
    refs, ests = [], []
    for j, (g, shift) in enumerate(((0.8, 0), (0.5, 3), (0.6, 1))):
        r = np.roll(data, 40 * j, axis=0) * g
        e = np.roll(r, shift, axis=0) + 0.05 * rng.standard_normal(r.shape)
        refs.append(str(tmp_path / f"r{j}.wav"))
        ests.append(str(tmp_path / f"e{j}.wav"))
        wavwrite(r, sr, refs[-1])
        wavwrite(e, sr, ests[-1])
    argv = ["eval", "-e", ests[2], ests[0], ests[1], "-r"] + refs + [
        "--filt-len", "64"]
    assert j_main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["permutation"] == want["permutation"] == [1, 2, 0]
    for key in ("sdr_db", "sir_db", "sar_db"):
        np.testing.assert_allclose(got[key], want[key], atol=0.01)


def test_checkpoints_cross_both_ways(mix_wav, tmp_path, capsys):
    """A JAX CLI checkpoint (8 iterations) resumed by the port's CLI with
    the same --iters runs zero iterations and writes the JAX run's
    separation (within 2 PCM16 steps); a port CLI checkpoint loads in the
    JAX package with its iteration and every leaf."""
    from pyfasst_tpu.utils.checkpoint import load_params as j_load
    from pyfasst_tpu_torch.utils.checkpoint import load_params
    base = [mix_wav, "--iters", "8", "--nmf-comps", "3", "--wlen", "256",
            "-q"]
    ck_j = str(tmp_path / "jax.npz")
    assert j_main(["separate", "-o", str(tmp_path / "j"), "--checkpoint",
                   ck_j] + base) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(["separate", "-o", str(tmp_path / "t"), "--resume", ck_j]
                + base + CPU) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["final_loglik"] is None and np.isfinite(want["final_loglik"])
    for a, b in zip(want["files"], got["files"]):
        da, db = wavread(a)[0], wavread(b)[0]
        assert da.shape == db.shape
        assert np.max(np.abs(da - db)) <= 2 / 32768

    ck_t = str(tmp_path / "torch.npz")
    assert main(["separate", "-o", str(tmp_path / "t2"), "--checkpoint",
                 ck_t] + base + CPU) == 0
    capsys.readouterr()
    params, it, _ = load_params(ck_t, device="cpu")
    j_params, j_it, _ = j_load(ck_t)
    assert it == j_it == 8
    for t_comp, j_comp in zip(params.spec + params.spat,
                              j_params.spec + j_params.spat):
        for name in ("FB", "TW", "A"):
            if hasattr(t_comp, name) and getattr(t_comp, name) is not None:
                np.testing.assert_array_equal(
                    getattr(t_comp, name)[0].numpy(),
                    np.asarray(getattr(j_comp, name)))


@pytest.mark.parametrize("argv,api", [
    (["--nmf-comps", "3", "--seed", "3", "--annealing", "no_ann"],
     dict(nbNMFComps=3, seed=3, annealing="no_ann")),
    (["--model", "fullrank", "--freq-basis", "erb", "--bands", "12",
      "--sources", "3"],
     dict(nbComps=3, spatial_rank=2, freq_basis="erb", n_bands=12)),
])
def test_separate_report_equals_api(mix_wav, tmp_path, capsys, argv, api):
    """On the CPU the CLI's loglik and WAVs are the API's, bit for bit."""
    from pyfasst_tpu_torch import MultiChanNMFConv, MultiChanNMFInst_FASST
    assert main(["separate", mix_wav, "-o", str(tmp_path / "cli"), "--iters",
                 "6", "--wlen", "256", "-q"] + argv + CPU) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cls = MultiChanNMFConv if "spatial_rank" in api else \
        MultiChanNMFInst_FASST
    kw = dict(nbComps=2, nbNMFComps=8, freq_basis=None, n_bands=40, seed=0,
              annealing="ann")
    kw.update(api)
    model = cls(mix_wav, wlen=256, iter_num=6, verbose=0, device="cpu",
                **kw)
    ll = model.estim_param_a_posteriori()
    paths = model.separate_spat_comps(str(tmp_path / "api"))
    assert rep["final_loglik"] == float(ll[-1])
    assert len(rep["files"]) == len(paths) == kw["nbComps"]
    for a, b in zip(rep["files"], paths):
        assert np.array_equal(wavread(a)[0], wavread(b)[0])


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fixture", ["speech", "music"])
def test_chip_smoke_fixtures_equal_the_tools(fixture, monkeypatch):
    """chip_smoke.py's copies of the speech and music fixture generators
    (its phase 17 runs the CLI on them, where tools/validate_hw.py, which
    imports JAX, cannot be imported) give the tools' arrays bit for bit, at
    a short length."""
    from pathlib import Path
    tools = str(Path(__file__).resolve().parent.parent / "tools")
    monkeypatch.syspath_prepend(tools)
    import speech_lab
    import validate_hw
    cs = _chip_smoke()
    if fixture == "speech":
        monkeypatch.setattr(speech_lab, "DUR", 0.5)
        mix, ys_true, n = speech_lab._fixture(3, 0.25, 120)
        got = cs.speech_fixture(**dict(cs.SPEECH, dur=0.5))
    else:
        m = cs.MUSIC
        rng = np.random.default_rng(m["seed"])
        n = int(m["fs"] * 0.5)
        srcs = validate_hw._music_sources(rng, n, m["fs"])
        ys_true = validate_hw._music_mix(
            rng, [srcs[k] for k in m["kinds"]], n, m["fs"], m["t60"],
            list(m["pans"]))
        mix = ys_true.sum(0)
        got = cs.music_fixture(**dict(m, dur=0.5))
    np.testing.assert_array_equal(got[0], mix)
    np.testing.assert_array_equal(got[1], ys_true)
