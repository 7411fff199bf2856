"""The E-step at sixteen sources, the most the kernel takes, against the
JAX package: as tests/test_torch_estep_many.py at J = 10 (the same bars,
inputs drawn with numpy from a seed), in a file of its own for the time
of the XLA compiles at J = 16 (~15-20 s each on one CPU thread). The
plain version of the general kernel (cuda_estep.estep_ref, through
suff_stats_cuda on CPU tensors) and the port's own E-step (ops/estep.py)
against the JAX XLA E-step, real rank 1 and complex rank 2.
"""
import numpy as np
import pytest
import torch

from pyfasst_tpu_torch.ops import estep
from tests.test_torch_estep_general import (
    _BARS_R1, _BARS_R2, _case_inputs, _compare_stats, _port_stats,
)
from tests.test_torch_estep_many import _xla
from tests.torch_parity import batched

torch.set_num_threads(1)

# name: (J, ranks, mix_type, F, N, noise_inject, real_cov, bars)
SIXTEEN = {
    "real_r1_J16": (16, (1,) * 16, "inst", 13, 33, False, True, _BARS_R1),
    "rank2_J16": (16, (2,) * 16, "conv", 9, 33, False, False, _BARS_R2),
}


@pytest.mark.parametrize("name", sorted(SIXTEEN))
def test_sixteen_sources_plain_version_matches_xla_estep(name):
    jin, tin, ranks, ns, real = _case_inputs(name, SIXTEEN)
    want = _xla(jin, ranks, ns)
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, want, len(ranks), SIXTEEN[name][-1])
    # the port's own E-step, on the same inputs (the same XLA compile)
    Rj = batched(np.asarray(jin[2]))               # packed R_j, (1, J, F, 4)
    got = estep.compute_suff_stats(tin[0], tin[1], Rj, tin[2], ranks,
                                   noise_inject=ns, A_conv=tin[3])
    _compare_stats(got, want, len(ranks), SIXTEEN[name][-1])
