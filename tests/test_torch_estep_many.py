"""The E-step past eight sources (J = 9 and 10) against the JAX package.

csrc/estep_j{9..16}.cu instantiate the general kernel for J = 9 to 16.
Its contract is the plain version cuda_estep.estep_ref, reached here
through suff_stats_cuda on CPU tensors; the port's own E-step
(ops/estep.py::compute_suff_stats, the CPU path of gem_step) takes any J.
Both are held against the JAX XLA E-step (compute_suff_stats) at J = 10
(J = 16: tests/test_torch_estep_sixteen.py, apart for the XLA compiles'
time), on inputs drawn with numpy from a seed, at the bars of
tests/test_torch_estep_wide.py (tests/test_pallas_estep.py's: rank 1 xi
rtol 2e-4, frame sums 2e-4, loglik 1e-4; rank 2 and mixed ranks xi 3e-4,
frame sums 5e-4; ns_inj as rank 2 with rank-1 atols); and the plain
version against the Pallas kernel in interpret mode at J = 9 (F = 9,
N = 40, real rank 1). The CUDA kernel is held against the plain version
by tests/test_torch_csrc_shim.py (its source compiled for the CPU) and, on
the card, by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from pyfasst_tpu.ops.pallas_estep import pallas_suff_stats
from pyfasst_tpu_torch.ops import estep
from tests.test_torch_estep_general import (
    _BARS_NS, _BARS_R1, _BARS_R2, _case_inputs, _compare_stats, _j_suff_stats,
    _port_stats,
)
from tests.torch_parity import batched

torch.set_num_threads(1)

# name: (J, ranks, mix_type, F, N, noise_inject, real_cov, bars), as
# tests/test_torch_estep_wide.py's WIDE: real rank 1 (the instantaneous
# model of `separate --sources 10`), complex rank 2 and noise injection at
# J = 10; real rank 1 at J = 9 for the Pallas kernel
MANY = {
    "real_r1_J9": (9, (1,) * 9, "inst", 9, 40, False, True, _BARS_R1),
    "real_r1_J10": (10, (1,) * 10, "inst", 17, 40, False, True, _BARS_R1),
    "rank2_J10": (10, (2,) * 10, "conv", 13, 33, False, False, _BARS_R2),
    "ns_inj_J10": (10, (1,) * 10, "conv", 13, 33, True, False, _BARS_NS),
}
_XLA = sorted(n for n in MANY if n != "real_r1_J9")


def _xla(jin, ranks, ns):
    return _j_suff_stats(*jin[:4], ranks, noise_inject=ns, A_conv=jin[4])


@pytest.mark.parametrize("name", _XLA)
def test_many_sources_plain_version_matches_xla_estep(name):
    jin, tin, ranks, ns, real = _case_inputs(name, MANY)
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, _xla(jin, ranks, ns), len(ranks), MANY[name][-1])


@pytest.mark.parametrize("name", ["real_r1_J10", "rank2_J10"])
def test_many_sources_port_estep_matches_xla_estep(name):
    jin, tin, ranks, ns, _ = _case_inputs(name, MANY)
    Rj = batched(np.asarray(jin[2]))               # the packed R_j, (1, J, F, 4)
    got = estep.compute_suff_stats(tin[0], tin[1], Rj, tin[2], ranks,
                                   noise_inject=ns, A_conv=tin[3])
    _compare_stats(got, _xla(jin, ranks, ns), len(ranks), MANY[name][-1])


def test_nine_sources_plain_version_matches_pallas():
    jin, tin, ranks, ns, real = _case_inputs("real_r1_J9", MANY)
    want = pallas_suff_stats(jin[0], jin[1], jin[2], jin[3], ranks, jin[4],
                             noise_inject=ns, interpret=True, real_cov=real)
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, want, len(ranks), MANY["real_r1_J9"][-1])
