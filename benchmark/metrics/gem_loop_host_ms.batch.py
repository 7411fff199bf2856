"""gem_loop_host_ms.batch: host ms an iteration in the span gem.run
(ops/gem.py::run_gem, one a call) less the spans inside it (the stages
gem.e_step, gem.m_spatial, gem.m_spectral): the noise PSD, the
log-likelihood's write and the Python loop, in the profiled GEM chunk
(iterations 60-80 of the first group); harness/spans.loop_ms."""
from harness.spans import loop_ms as read  # noqa: F401
