"""m_spectral_host_ms.batch: host ms an iteration in the span
gem.m_spectral (ops/gem.py::gem_step: the fused or plain spectral M-step
and renormalize), less the spans inside it, in the profiled GEM chunk
(iterations 60-80 of the first group); harness/spans.stage_ms."""
from harness.spans import stage_ms


def read(r):
    return stage_ms(r, "gem.m_spectral")
