"""The port's own spans of the profiled GEM chunk, for the readers of the
GEM loop's stages (benchmark/metrics/*_host_ms.batch.py).

The port records a span (pyfasst_tpu_torch/utils/logging.py: name, parent,
start and end in ns) only while a torch profiler records, and nothing here
runs under one but the traced window (harness/profile.record), so its
buffer holds that chunk alone. A program without spans reads None."""


def self_ns(name: str):
    """(count, total ns) of the spans named `name`, each less the time of
    the spans inside it; None where the program records no spans."""
    from pyfasst_tpu_torch.utils import logging as tlog
    spans = getattr(tlog, "spans", None)
    if spans is None:
        return None
    recs = list(spans())
    inside = {}
    for s in recs:
        if s.parent is not None:
            inside[s.parent] = inside.get(s.parent, 0) + s.end_ns - s.start_ns
    own = [s.end_ns - s.start_ns - inside.get(s.id, 0) for s in recs
           if s.name == name]
    return len(own), sum(own)


def stage_ms(r, name: str):
    """Host ms an iteration in the stage span `name` less the spans inside
    it, over the traced chunk; None without a trace or spans, or where the
    span's count is not the chunk's iterations."""
    found = None if r.trace is None else self_ns(name)
    if found is None or found[0] != r.trace["steps"]:
        return None
    return found[1] / 1e6 / found[0]


def loop_ms(r):
    """Host ms an iteration in gem.run (one a call of run_gem) less its
    stages; None as stage_ms, the iterations counted by gem.e_step."""
    if r.trace is None:
        return None
    run, iters = self_ns("gem.run"), self_ns("gem.e_step")
    if run is None or iters[0] != r.trace["steps"]:
        return None
    return run[1] / 1e6 / iters[0]
