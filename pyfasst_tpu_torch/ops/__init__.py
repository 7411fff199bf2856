"""Device compute: Hermitian 2x2 algebra, GEM E/M steps, Wiener separation.

Port of pyfasst_tpu/ops. cuda_estep and cuda_spectral bind the hand-written
E-step and spectral M-step kernels; importing them builds nothing (the
kernels are compiled at their first CUDA use).
"""

from pyfasst_tpu_torch.ops import (  # noqa: F401
    herm, estep, cuda_estep, mstep, cuda_spectral, gem, wiener,
)
