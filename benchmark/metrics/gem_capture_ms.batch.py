"""gem_capture_ms.batch: host ms of a gem.capture span (ops/gem.py: one
GEM iteration captured as a CUDA graph, the stages' spans inside it
included) in the profiled GEM chunk (iterations 60-80 of the first
group), the mean; None without a trace or where the chunk holds no
capture."""
import importlib


def read(r):
    if r.trace is None:
        return None
    tlog = importlib.import_module("pyfasst_tpu_torch.utils.logging")
    spans = getattr(tlog, "spans", None)
    if spans is None:
        return None
    caps = [s.end_ns - s.start_ns for s in spans() if s.name == "gem.capture"]
    return sum(caps) / len(caps) / 1e6 if caps else None
