"""gem_mfu.batch: the operations of one GEM iteration at the cell's shapes
(harness/counts.gem_iteration_ops: the sources' powers, the E-step counted
as general_ops counts it, both M-steps and renormalize, on the frozen plain
copies) over gem_iter_ms.batch, against the H100's 67 TFLOP/s of float32,
in %. The same count whichever code runs the iteration."""
from harness.counts import FP32_OPS_PER_S
from harness.readers import gem_iter_s


def read(r):
    s = gem_iter_s(r)
    if s is None:
        return None
    return 100.0 * r.figures()["gem_ops"]["total"] / s / FP32_OPS_PER_S
