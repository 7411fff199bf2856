"""The general E-step kernel's plain version at five to eight sources.

csrc/estep_j{5,6,7,8}.cu instantiate the general kernel for J = 5 to 8
(the 2-8 sources of FASST's own range; J = 9 to 16:
tests/test_torch_estep_many.py and test_torch_estep_sixteen.py). Their contract is the plain version
cuda_estep.estep_ref, reached here through suff_stats_cuda on CPU tensors,
held against the JAX package at tests/test_pallas_estep.py's bars: against
the JAX XLA E-step (compute_suff_stats) in every case, and against the
Pallas kernel in interpret mode in the cases whose interpret-mode compile
stays short (rank 1 real at J = 5 and 8, mixed ranks and noise injection
at J = 5; the kernel at J = 8 rank 2 takes ~80 s to compile in interpret
mode on one CPU thread). The CUDA kernel is held against this plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import pytest
import torch

from pyfasst_tpu.ops.pallas_estep import pallas_suff_stats
from pyfasst_tpu_torch.ops import cuda_estep
from tests.test_torch_estep_general import (
    _BARS_NS, _BARS_R1, _BARS_R2, _case_inputs, _compare_stats, _j_suff_stats,
    _port_stats,
)

torch.set_num_threads(1)

# name: (J, ranks, mix_type, F, N, noise_inject, real_cov, bars), as
# tests/test_torch_estep_general.py's CASES: real rank 1 (the instantaneous
# model of `separate --sources 5`), complex rank 2, mixed ranks and noise
# injection at J = 5; real rank 1 and complex rank 2 at J = 8, the largest
# J the kernel takes. The CUDA kernel takes every case here in one of
# its 128-frame tiles; tests/test_torch_csrc_shim.py crosses the tiles
WIDE = {
    "real_r1_J5": (5, (1,) * 5, "inst", 17, 40, False, True, _BARS_R1),
    "rank2_J5": (5, (2,) * 5, "conv", 21, 50, False, False, _BARS_R2),
    "mixed_J5": (5, (1, 2, 2, 1, 2), "conv", 21, 50, False, False,
                 _BARS_R2),
    "ns_inj_J5": (5, (1,) * 5, "conv", 17, 40, True, False, _BARS_NS),
    "real_r1_J8": (8, (1,) * 8, "inst", 17, 33, False, True, _BARS_R1),
    "rank2_J8": (8, (2,) * 8, "conv", 13, 33, False, False, _BARS_R2),
}
_PALLAS = ("real_r1_J5", "mixed_J5", "ns_inj_J5", "real_r1_J8")


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_plain_version_matches_xla_estep(name):
    jin, tin, ranks, ns, real = _case_inputs(name, WIDE)
    want = _j_suff_stats(*jin[:4], ranks, noise_inject=ns, A_conv=jin[4])
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, want, len(ranks), WIDE[name][-1])


@pytest.mark.parametrize("name", _PALLAS)
def test_wide_plain_version_matches_pallas(name):
    jin, tin, ranks, ns, real = _case_inputs(name, WIDE)
    want = pallas_suff_stats(jin[0], jin[1], jin[2], jin[3], ranks, jin[4],
                             noise_inject=ns, interpret=True, real_cov=real)
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, want, len(ranks), WIDE[name][-1])


@pytest.mark.parametrize("J", tuple(range(5, 17)))
def test_kernel_takes_five_to_sixteen_sources(J):
    """kernel_eligible passes J = 5..16 at every rank mix and flag, and
    J = 17 (csrc/estep_many.cu, J at run time) and on to MAX_SOURCES;
    past that it refuses, naming why."""
    for ranks in ((1,) * J, (2,) * J, (1, 2) * (J // 2) + (1,) * (J % 2)):
        for real, ns, fast in ((True, False, False), (False, True, True)):
            assert cuda_estep.kernel_eligible(
                ranks, real, ns, torch.float32, fast, 2) == ""
    for many in (17, cuda_estep.MAX_SOURCES):
        assert cuda_estep.kernel_eligible((1,) * many, True, False,
                                          torch.float32, False, 2) == ""
    why = cuda_estep.kernel_eligible((1,) * (cuda_estep.MAX_SOURCES + 1),
                                     True, False, torch.float32, False, 2)
    assert f"J = {cuda_estep.MAX_SOURCES + 1}" in why and "bit mask" in why
