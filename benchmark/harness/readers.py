"""What several metric readers (benchmark/metrics/<name>.py) read alike,
each from the run's readings (run.Readings)."""


def idle_share(r):
    """The share of the profiled GEM chunk in which no kernel runs: 1 -
    the union of the kernels' intervals over the window, in %."""
    t = r.trace
    if t is None or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def gem_iter_s(r):
    """Seconds an iteration of the GEM loop, by the host clock around the
    traced window's calls of it (their "gem_s" spans), the mean."""
    s = r.spans["gem_s"]
    return sum(s) / len(s) / r.niter if s else None


def xrt(r):
    """Audio-seconds of every unit completed in the window over the
    window's wall time."""
    return r.units * r.audio_s / r.window_s if r.units else None
