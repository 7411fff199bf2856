"""frontend_ms.batch: device ms a pipeline between CUDA events around the
STFT (tf/stft.py::_stft_core), the Wiener images with their noise floor
(ops/wiener.py::separate_sources, ops/gem.py::annealing_endpoints) and the
inverse STFT (_istft_core), summed; the mean over the traced window."""


def read(r):
    ev = r.spans["events"]
    return 1e3 * sum(e.seconds() for e in ev) / len(ev) if ev else None
