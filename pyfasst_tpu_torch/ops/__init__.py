"""Device compute: Hermitian 2x2 algebra, GEM E/M steps, Wiener separation.

Port of pyfasst_tpu/ops. cuda_estep binds the hand-written E-step kernels;
importing it builds nothing (they are compiled at their first CUDA use).
"""

from pyfasst_tpu_torch.ops import (  # noqa: F401
    herm, estep, cuda_estep, mstep, gem, wiener,
)
