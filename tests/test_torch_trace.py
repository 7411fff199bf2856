"""The port's spans (utils/logging.py): recorded exactly while a torch
profiler records, nested as the program runs, present among the
profiler's host events and nowhere among its device events, and free of
any effect on the numbers. CPU at tiny shapes; one test needs a card
(marker `cuda`).
"""
import collections
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pyfasst_tpu_torch.__main__ import main
from pyfasst_tpu_torch.audio import wavwrite
from pyfasst_tpu_torch.models.variants import MultiChanNMFInst_FASST
from pyfasst_tpu_torch.ops import gem
from pyfasst_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("gem.e_step", "gem.m_spatial", "gem.m_spectral")
FS = 8000


def _mix(channels, seconds=0.25, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    s = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                  0.3 * rng.standard_normal(t.size)])
    gains = rng.uniform(0.2, 1.0, (channels, 2))
    return (gains @ s).T                                   # (T, channels)


def _model(audio, niter=4, device="cpu"):
    return MultiChanNMFInst_FASST(audio, fs=FS, nbComps=2, nbNMFComps=3,
                                  wlen=64, iter_num=niter, device=device)


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """fn() under the profiler; (its result, the profile, the spans it
    recorded)."""
    tlog.spans().clear()
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, prof, list(tlog.spans())


def _self_ns(recs):
    """{span id: its duration less the durations of its child spans}."""
    inside = collections.Counter()
    for s in recs:
        if s.parent is not None:
            inside[s.parent] += s.end_ns - s.start_ns
    return {s.id: s.end_ns - s.start_ns - inside[s.id] for s in recs}


@pytest.mark.parametrize("channels", [2, 3])
def test_run_gem_spans_nest_in_the_run(channels):
    """One gem.run a call and one span of each stage an iteration, each
    stage's parent the run; the I = 2 path and the general-I path alike.
    Self times are non-negative and add up to the run's duration."""
    n = 5
    m = _model(_mix(channels), niter=n)
    _, _, recs = _profiled(lambda: gem.run_gem(m.params, m.Xs, m.cfg))
    names = collections.Counter(s.name for s in recs)
    assert names == {"gem.run": 1, **{st: n for st in STAGES}}
    run = next(s for s in recs if s.name == "gem.run")
    assert run.parent is None
    for s in recs:
        if s.name in STAGES:
            assert s.parent == run.id
            assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns
    own = _self_ns(recs)
    assert min(own.values()) >= 0
    assert sum(own.values()) == run.end_ns - run.start_ns


def test_spans_are_host_events_of_the_profile():
    """Each span is an event of the profile with device type CPU, as many
    times as the buffer holds it."""
    m = _model(_mix(2))
    _, prof, recs = _profiled(lambda: gem.run_gem(m.params, m.Xs, m.cfg))
    want = collections.Counter(s.name for s in recs)
    got = collections.Counter(e.name for e in prof.events()
                              if e.name in want)
    assert got == want
    assert {e.device_type for e in prof.events()
            if e.name in want} == {DeviceType.CPU}


def test_nothing_is_recorded_outside_a_profiler(tmp_path):
    path = str(tmp_path / "mix.wav")
    wavwrite(_mix(2), FS, path)
    tlog.spans().clear()
    m = _model(path)
    m.estim_param_a_posteriori()
    m.separate_spat_comps(str(tmp_path / "out"))
    with tlog.span("outside"):
        pass
    assert not tlog.recording()
    assert len(tlog.spans()) == 0


@pytest.mark.parametrize("channels", [2, 3])
def test_profiler_changes_no_number(channels):
    """Log-likelihoods and parameters bit for bit with the profiler on and
    off."""
    m = _model(_mix(channels), niter=6)
    off = gem.run_gem(m.params, m.Xs, m.cfg)
    on, _, recs = _profiled(lambda: gem.run_gem(m.params, m.Xs, m.cfg))
    assert len(recs) == 1 + 6 * len(STAGES)
    assert torch.equal(off[1], on[1])
    for a, b in zip(off[0].spat + off[0].spec, on[0].spat + on[0].spec):
        for name in ("A", "FB", "TW"):
            if hasattr(a, name):
                assert torch.equal(getattr(a, name), getattr(b, name))


def test_host_api_stages(tmp_path):
    """MultiChanNMFInst_FASST from a WAV to WAVs records its stages:
    api.read and stft inside api.init, gem.run inside api.gem, then
    wiener, istft and api.write."""
    path = str(tmp_path / "mix.wav")
    wavwrite(_mix(2), FS, path)

    def host():
        m = _model(path, niter=3)
        m.estim_param_a_posteriori()
        return m.separate_spat_comps(str(tmp_path / "out"))
    paths, _, recs = _profiled(host)
    assert len(paths) == 2
    assert collections.Counter(s.name for s in recs) == {
        "api.init": 1, "api.read": 1, "stft": 1, "api.gem": 1,
        "gem.run": 1, **{st: 3 for st in STAGES}, "wiener": 1,
        "istft": 1, "api.write": 1}
    name = {s.id: s.name for s in recs}
    parent = {s.name: name.get(s.parent) for s in recs}
    assert parent["api.read"] == parent["stft"] == "api.init"
    assert parent["gem.run"] == "api.gem"
    assert {parent[n] for n in ("api.init", "api.gem", "wiener", "istft",
                                "api.write")} == {None}


def test_benchmark_readers_split_the_run():
    """The benchmark's four readers of the GEM loop's spans, on a chunk of
    iterations 60-80 profiled as the traced run profiles it: per
    iteration they add up to the run's duration; a chunk of another
    length, or no trace, reads None."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from harness import manifest
        read = {n: manifest.reader(ROOT, n) for n in (
            "e_step_host_ms.batch", "m_spatial_host_ms.batch",
            "m_spectral_host_ms.batch", "gem_loop_host_ms.batch")}
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    m = _model(_mix(2), niter=100)
    _, _, recs = _profiled(lambda: gem.run_gem(m.params, m.Xs, m.cfg,
                                               start_iter=60, end_iter=80))
    (run,) = [s for s in recs if s.name == "gem.run"]
    r = types.SimpleNamespace(trace={"steps": 20})
    got = {n: f(r) for n, f in read.items()}
    assert min(got.values()) > 0
    assert sum(got.values()) == pytest.approx(
        (run.end_ns - run.start_ns) / 1e6 / 20, rel=1e-9)
    for trace in ({"steps": 19}, None):
        r.trace = trace
        assert {f(r) for f in read.values()} == {None}


def test_an_error_closes_the_span_and_its_children():
    def fail():
        with tlog.span("outer"):
            tlog.begin("inner")
            raise ValueError("stop")
    with pytest.raises(ValueError):
        _profiled(fail)
    recs = list(tlog.spans())
    assert [s.name for s in recs] == ["inner", "outer"]
    assert recs[0].parent == recs[1].id
    with profile(activities=[ProfilerActivity.CPU]):
        with tlog.span("next"):
            pass
    assert tlog.spans()[-1].parent is None


def test_separate_trace_dir_writes_the_spans(tmp_path):
    """`separate --trace-dir DIR` runs under the profiler and writes a
    Chrome trace that holds the host API's, the front end's and the GEM
    loop's spans."""
    path = str(tmp_path / "mix.wav")
    wavwrite(_mix(2), FS, path)
    rc = main(["separate", path, "-o", str(tmp_path / "out"), "--iters",
               "2", "--wlen", "64", "--nmf-comps", "3", "-q", "--device",
               "cpu", "--trace-dir", str(tmp_path / "trace")])
    assert rc == 0
    (trace,) = (tmp_path / "trace").iterdir()
    names = {e.get("name")
             for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"api.init", "api.read", "stft", "api.gem", "gem.run", *STAGES,
            "wiener", "istft", "api.write"} <= names


@pytest.mark.cuda
def test_spans_add_no_device_event():
    """Under CUDA activity no CUDA-type event carries a span's name (the
    kernels' list of a trace holds kernels only), the spans of run_gem's
    CUDA graphs (gem.capture, gem.replay) included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device's trace exists only "
                    "on the card")
    m = _model(_mix(2), niter=3, device="cuda")
    gem.run_gem(m.params, m.Xs, m.cfg)
    torch.cuda.synchronize()

    def run():
        out = gem.run_gem(m.params, m.Xs, m.cfg)
        torch.cuda.synchronize()
        return out
    _, prof, recs = _profiled(run, (ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA))
    names = {s.name for s in recs}
    assert names == {"gem.run", "gem.capture", "gem.replay", *STAGES}
    events = list(prof.events())
    assert any(e.device_type == DeviceType.CUDA for e in events)
    assert not {e.name for e in events
                if e.device_type == DeviceType.CUDA} & names
