"""estep_roofline.batch: the E-step's least time at the cell's shapes
(harness/counts.estep_bound: bytes read and written once at 3.35 TB/s, or
the frozen plain version's operations at 67 TFLOP/s, the larger) over the
device time an iteration of the E-step's kernels (names matching
"estep" or "segments") in the profiled GEM chunk, in %."""
from harness.profile import kernel_seconds


def read(r):
    if r.trace is None:
        return None
    t = kernel_seconds(r.trace, r"estep|segments")
    return 100.0 * r.figures()["estep_bound_s"] / t if t > 0 else None
