"""device_idle.batch: the share of the profiled GEM chunk (iterations
60-80 of the first group) in which no kernel runs: 1 - the union of the
kernels' intervals over the window, in %."""
from harness.readers import idle_share as read  # noqa: F401
