"""spectral_roofline.batch: the least time of one fb_stats and one
tw_stats call at the cell's shapes (harness/counts.spectral_bound, each
bounded as the E-step is) over the device time an iteration of the fused
spectral M-step's kernels (fb_stats, tw_stats, stats_tile, sum_splits) in
the profiled GEM chunk, in %. Silent where those kernels do not run."""
from harness.profile import kernel_seconds


def read(r):
    if r.trace is None:
        return None
    t = kernel_seconds(r.trace, r"fb_stats|tw_stats|stats_tile|sum_splits")
    return 100.0 * r.figures()["spectral_bound_s"] / t if t > 0 else None
