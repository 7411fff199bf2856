"""e_step_host_ms.batch: host ms an iteration in the span gem.e_step
(ops/gem.py::gem_step: the sources' powers, the E-step's dispatch and
reduce_stats), less the spans inside it, in the profiled GEM chunk
(iterations 60-80 of the first group); harness/spans.stage_ms."""
from harness.spans import stage_ms


def read(r):
    return stage_ms(r, "gem.e_step")
