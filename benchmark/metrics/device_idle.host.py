"""device_idle.host: the share of the profiled GEM chunk (iterations 60-80
of clip 0, run as the host API runs a chunk of them) in which no kernel
runs: 1 - the union of the kernels' intervals over the window, in %."""
from harness.readers import idle_share as read  # noqa: F401
