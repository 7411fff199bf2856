"""Wiener separation of the port against the JAX package, on the same
mixture, parameters and noise PSD.

float32: rtol 1e-5 with a floor of 1e-6 of the largest image entry (the
same closed forms, rounded in a different order). float64 (JAX under
enable_x64): rtol 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from pyfasst_tpu.ops import wiener as jw
from pyfasst_tpu_torch.ops import wiener
from tests.torch_parity import batched, jax_problem, to_torch_params

torch.set_num_threads(1)

TOL = {np.float32: (1e-5, 1e-6), np.float64: (1e-10, 1e-12)}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
FUNCS = ["separate_sources", "separate_spatial_filter", "posterior_psd_masks"]


def _case(fn, mix, ranks, dtype):
    rng = np.random.default_rng(len(fn) + sum(ranks))
    X, jp, sigma = jax_problem(rng, F=17, N=30, mix_type=mix, ranks=ranks,
                               dtype=dtype)
    want = np.asarray(getattr(jw, fn)(jp, jnp.asarray(X), jnp.asarray(sigma)))
    got = getattr(wiener, fn)(to_torch_params(jp, TDT[dtype]), batched(X),
                              batched(sigma))
    assert tuple(got.shape) == (1,) + want.shape
    rtol, floor = TOL[dtype]
    np.testing.assert_allclose(got[0].numpy(), want, rtol=rtol,
                               atol=floor * np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mix,ranks", [("inst", (1, 1)), ("conv", (1, 1)),
                                       ("conv", (2, 2))])
@pytest.mark.parametrize("fn", FUNCS)
def test_wiener_matches_jax(fn, mix, ranks, dtype):
    if dtype == np.float64:
        with enable_x64():
            _case(fn, mix, ranks, dtype)
    else:
        _case(fn, mix, ranks, dtype)


def test_images_sum_to_mixture_as_noise_vanishes():
    """Conservation: sum_j y_j -> x as sigma -> 0 (float64)."""
    rng = np.random.default_rng(9)
    with enable_x64():
        X, jp, sigma = jax_problem(rng, F=17, N=30, dtype=np.float64)
        tp = to_torch_params(jp, torch.float64)
    Y = wiener.separate_sources(tp, batched(X), batched(sigma) * 1e-9)
    err = (Y.sum(dim=1) - batched(X)).abs().max() / batched(X).abs().max()
    assert float(err) < 1e-6


def test_general_channel_count_not_ported():
    """I != 2 was refused before the general-I engine was ported; both
    separations now dispatch to it, as the JAX package's do, and give its
    numbers (float32, the bars of this file)."""
    rng = np.random.default_rng(10)
    X, jp, sigma = jax_problem(rng, F=9, N=10)
    X3 = np.concatenate([X, X[..., :1]], axis=-1)
    jp3 = jp.replace(spat=tuple(
        c.replace(A=jnp.concatenate([c.A, c.A[:1]], axis=0))
        for c in jp.spat))
    for fn in ("separate_sources", "separate_spatial_filter"):
        want = np.asarray(getattr(jw, fn)(jp3, jnp.asarray(X3),
                                          jnp.asarray(sigma)))
        got = getattr(wiener, fn)(to_torch_params(jp3), batched(X3),
                                  batched(sigma))
        assert tuple(got.shape) == (1, 2, 9, 10, 3)
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.max(np.abs(want)))
