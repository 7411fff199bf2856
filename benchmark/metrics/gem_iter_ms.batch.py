"""gem_iter_ms.batch: ms an iteration of ops/gem.py::run_gem, by the host
clock between a synchronise before the call and one after it; the mean
over the traced window's pipelines."""
from harness.readers import gem_iter_s


def read(r):
    s = gem_iter_s(r)
    return None if s is None else 1e3 * s
