"""Device compute: Hermitian 2x2 algebra, GEM E/M steps, the general-I
engine, Wiener separation, online (streaming) GEM.

Port of pyfasst_tpu/ops. cuda_estep and cuda_spectral bind the hand-written
E-step and spectral M-step kernels; importing them builds nothing (the
kernels are compiled at their first CUDA use). engine_general (I != 2) is
plain PyTorch on every device.
"""

from pyfasst_tpu_torch.ops import (  # noqa: F401
    herm, estep, cuda_estep, engine_general, mstep, cuda_spectral, gem,
    wiener, online,
)
from pyfasst_tpu_torch.ops.online import (  # noqa: F401
    online_block, online_init, run_gem_online,
)
