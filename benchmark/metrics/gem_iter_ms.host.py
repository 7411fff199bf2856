"""gem_iter_ms.host: ms an iteration of estim_param_a_posteriori (the GEM
loop under the host API, which waits for the device at its end); the mean
over the traced window's clips."""
from harness.readers import gem_iter_s


def read(r):
    s = gem_iter_s(r)
    return None if s is None else 1e3 * s
