"""gem_graph_share.batch: the share of the profiled GEM chunk's iterations
(60-80 of the first group) that ran as replays of a captured CUDA graph:
the port's gem.replay spans (ops/gem.py::run_gem, one a replayed
iteration) over the chunk's iterations, in %. None without a trace, or
where the program has no graphed loop (no ops/gem.py GRAPH_STEPS)."""
import importlib

from harness.spans import self_ns


def read(r):
    if r.trace is None:
        return None
    gem = importlib.import_module("pyfasst_tpu_torch.ops.gem")
    if not hasattr(gem, "GRAPH_STEPS"):
        return None
    found = self_ns("gem.replay")
    return None if found is None else 100.0 * found[0] / r.trace["steps"]
