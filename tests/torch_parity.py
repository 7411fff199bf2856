"""Shared helpers of the tests that hold pyfasst_tpu_torch against the JAX
package: problems made with numpy from a seed, handed to both packages as
the same numbers."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyfasst_tpu.models.components import (
    FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_tpu_torch import convert


def jax_problem(rng, F=33, N=40, J=2, K=3, mix_type="inst", ranks=None,
                dtype=np.float32):
    """X (F, N, 2) complex numpy, JAX FasstParams, sigma (F,) numpy.

    dtype float64 must be used under jax.enable_x64()."""
    cdt = np.complex128 if dtype == np.float64 else np.complex64
    ranks = ranks or (1,) * J
    X = (rng.standard_normal((F, N, 2))
         + 1j * rng.standard_normal((F, N, 2))).astype(cdt)
    X[:, :, 0] *= np.linspace(0.5, 2.0, F)[:, None].astype(dtype)
    spat, spec = [], []
    for j in range(J):
        if mix_type == "inst" and ranks[j] == 1:
            A = jnp.asarray(np.abs(rng.standard_normal((2, 1))) + 0.3, dtype)
            spat.append(SpatialComp(A=A, mix_type="inst"))
        else:
            A = (rng.standard_normal((F, 2, ranks[j]))
                 + 1j * rng.standard_normal((F, 2, ranks[j]))) * 0.5
            spat.append(SpatialComp(A=jnp.asarray(A.astype(cdt)),
                                    mix_type="conv"))
        spec.append(SpectralComp(
            FB=jnp.asarray(0.5 + rng.random((F, K)), dtype),
            TW=jnp.asarray(0.5 + rng.random((K, N)), dtype), spat_ind=j))
    sigma = (0.01 + 0.005 * rng.random(F)).astype(dtype)
    return X, FasstParams(spat=tuple(spat), spec=tuple(spec)), sigma


def to_torch_params(jparams, dtype=torch.float32):
    """The same parameters as a pyfasst_tpu_torch FasstParams (B = 1)."""
    return convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     dtype=dtype)


def batched(a, dtype=None):
    """numpy (or JAX) array -> torch tensor with a leading clip axis."""
    t = torch.as_tensor(np.array(a))[None]
    return t if dtype is None else t.to(dtype)


def assert_close(got, want, rtol, atol=0.0):
    """got: torch tensor (the port); want: JAX/numpy array."""
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(g), np.asarray(want), rtol=rtol,
                               atol=atol)
