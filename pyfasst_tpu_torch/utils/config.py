"""Typed configuration for the GEM engine.

Port of pyfasst_tpu/utils/config.py. The knobs and their defaults are the
JAX package's, with one change: there is no ``use_pallas`` switch. The device
of the tensors decides the E-step path (ops/gem.py::gem_step): a CPU tensor
takes the plain PyTorch E-step, a CUDA tensor the hand-written kernel or an
error. ``fast_recip`` and ``fuse_spectral`` select kernels on CUDA (the
E-step's variant e; the fb_stats and tw_stats kernels) and change nothing
on the CPU, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import enum


class AnnealingMode(str, enum.Enum):
    """Noise-PSD annealing schedule of the GEM loop.

    The annealed noise PSD is load-bearing for the conditioning of the
    per-bin 2x2 mixture covariance, not just for local-optima escape.
    """

    ANN = "ann"                 # anneal Sigma_b from sigma0 down to sigma1
    NO_ANN = "no_ann"           # keep Sigma_b fixed at sigma1
    ANN_NS_INJ = "ann_ns_inj"   # anneal + inject matching noise into Cx stats


@dataclasses.dataclass(frozen=True)
class GEMConfig:
    """Static configuration of one GEM run."""

    niter: int = 200
    annealing: AnnealingMode = AnnealingMode.ANN
    # Noise PSD endpoints as fractions of the per-frequency mean mixture
    # power. The final floor keeps cond(Sigma_x) within what float32 2x2
    # determinants can resolve (~1e6). The schedule interpolates the
    # endpoints linearly, so at small niter the last step still shrinks
    # sigma by orders of magnitude at once.
    sigma_start_frac: float = 1e-2
    sigma_end_frac: float = 3e-6
    # Numerical floors (IS divergence and 2x2 inverses blow up on zeros).
    eps: float = 1e-30
    det_floor: float = 1e-30
    # Per-frequency power floor relative to the global mean power: silent
    # bins otherwise drive sigma_b below the float32 denormal range and the
    # 1/sigma spatial-pooling weights overflow.
    power_floor_frac: float = 1e-4
    # Renormalize factor/mixing scales every iteration.
    renormalize: bool = True
    # Fused spectral M-step kernels (ops/cuda_spectral.py) for eligible
    # params on CUDA; the CPU path ignores it as the JAX CPU path does.
    fuse_spectral: bool = False
    # Approximate reciprocals in the E-step kernels on CUDA (variant e); the
    # CPU path always divides exactly, as in JAX.
    fast_recip: bool = False
    # Hold the spatial mixing fixed for the first frac of iterations, while
    # the random initial spectra adapt (source-collapse remedy).
    spatial_hold_frac: float = 0.1

    def __post_init__(self):
        if isinstance(self.annealing, str):
            object.__setattr__(self, "annealing", AnnealingMode(self.annealing))


def load_config(source) -> GEMConfig:
    """GEMConfig from a dict, a JSON file path, or a GEMConfig. Unknown keys
    raise (typos should not silently fall back to defaults)."""
    if isinstance(source, GEMConfig):
        return source
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        import json
        with open(source) as fh:
            source = json.load(fh)
    if not isinstance(source, dict):
        raise TypeError(f"cannot load GEMConfig from {type(source)}")
    valid = {f.name for f in dataclasses.fields(GEMConfig)}
    unknown = set(source) - valid
    if unknown:
        raise ValueError(f"unknown GEMConfig keys: {sorted(unknown)}")
    return GEMConfig(**source)
