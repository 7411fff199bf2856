"""The E-step at seventeen sources, the first J of csrc/estep_many.cu,
against the JAX package.

The kernel's contract is the plain version cuda_estep.estep_ref, reached
here through suff_stats_cuda on CPU tensors: held against the Pallas
kernel in interpret mode (pallas_estep, which the JAX package's gem_step
takes at any J) on a small plane, real rank 1 (the instantaneous model of
`separate --sources 20`), at the bars of tests/test_pallas_estep.py
(tests/test_torch_estep_wide.py's _BARS_R1). Tracing and compiling the
kernel's body, O(J^3) terms in its leave-one-out dets, takes ~1.5-2.5
min on one CPU thread whatever the plane, so complex rank 2 is left to
the kernel's own tests below. Then three GEM iterations of the port at
J = 17 against the JAX
package's run_gem on the CPU (its XLA E-step), from the same parameters
carried across by convert.params_from_numpy, at tests/test_torch_gem.py's
float32 bars (loglik rtol 1e-5, parameters rtol 1e-4 with a floor of 1e-6
of the largest entry). The CUDA kernel is held against the plain version
by tests/test_torch_csrc_shim_many.py (its source compiled for the CPU) and,
on the card, by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import torch

from pyfasst_tpu.ops import gem as jgem
from pyfasst_tpu.ops.pallas_estep import pallas_suff_stats
from pyfasst_tpu.utils.config import GEMConfig as JConfig
from pyfasst_tpu_torch.ops import gem
from pyfasst_tpu_torch.utils.config import GEMConfig
from tests.test_torch_estep_general import (
    _BARS_R1, _case_inputs, _compare_stats, _port_stats,
)
from tests.test_torch_gem import _compare
from tests.torch_parity import batched, jax_problem, to_torch_params

torch.set_num_threads(1)

# name: (J, ranks, mix_type, F, N, noise_inject, real_cov, bars)
SEVENTEEN = {
    "real_r1_J17": (17, (1,) * 17, "inst", 5, 21, False, True, _BARS_R1),
}


def test_seventeen_sources_plain_version_matches_pallas():
    jin, tin, ranks, ns, real = _case_inputs("real_r1_J17", SEVENTEEN)
    want = pallas_suff_stats(jin[0], jin[1], jin[2], jin[3], ranks, jin[4],
                             noise_inject=ns, interpret=True, real_cov=real)
    got = _port_stats(tin, ranks, ns, real)
    _compare_stats(got, want, len(ranks), SEVENTEEN["real_r1_J17"][-1])


def test_seventeen_sources_gem_matches_jax():
    rng = np.random.default_rng(17)
    X, jp, _ = jax_problem(rng, F=9, N=24, J=17)
    want_p, want_ll = jgem.run_gem(jp, jnp.asarray(X), JConfig(niter=3))
    got_p, got_ll = gem.run_gem(to_torch_params(jp), batched(X),
                                GEMConfig(niter=3))
    assert got_ll.shape == (1, 3)
    _compare(got_p, got_ll, want_p, want_ll, 0, 1e-5, 1e-4, 1e-6)
