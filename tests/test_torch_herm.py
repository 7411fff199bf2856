"""pyfasst_tpu_torch.ops.herm against pyfasst_tpu.ops.herm on the same
numpy inputs.

Tolerance: rtol 2e-6, atol 1e-6 in float32. The two packages evaluate the
same closed forms, so they differ only where XLA's CPU fusion contracts a
multiply-add that PyTorch rounds in two steps (one float32 ulp, ~6e-8, per
operation, a few operations deep).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyfasst_tpu.ops import herm as jherm
from pyfasst_tpu_torch.ops import herm as therm

torch.set_num_threads(1)

SHAPE = (5, 7)


def _pd(rng):
    """Packed Hermitian PD matrices (..., 4)."""
    a = 1.0 + rng.random(SHAPE)
    d = 1.0 + rng.random(SHAPE)
    br, bi = 0.4 * rng.standard_normal((2,) + SHAPE)
    return np.stack([a, d, br, bi], axis=-1).astype(np.float32)


def _c(rng, shape=SHAPE):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _herm_complex(rng):
    P = _pd(rng)
    return np.array(jherm.herm_to_complex(jnp.asarray(P)))


CASES = {
    "pack_herm": lambda r: (r.random(SHAPE).astype(np.float32),
                            r.random(SHAPE).astype(np.float32), _c(r)),
    "herm_from_complex": lambda r: (_herm_complex(r),),
    "herm_to_complex": lambda r: (_pd(r),),
    "herm_from_outer": lambda r: (_c(r), _c(r)),
    "det": lambda r: (_pd(r),),
    "load_diag": lambda r: (_pd(r),),
    "inv": lambda r: (_pd(r),),
    "trace": lambda r: (_pd(r),),
    "trace_prod": lambda r: (_pd(r), _pd(r)),
    "congruence": lambda r: (_pd(r), _pd(r)),
    "mul": lambda r: (_pd(r), _pd(r)),
    "gen_to_complex": lambda r: (r.standard_normal(SHAPE + (8,))
                                 .astype(np.float32),),
    "gen_apply": lambda r: (r.standard_normal(SHAPE + (8,))
                            .astype(np.float32), _c(r), _c(r)),
    "add_noise_diag": lambda r: (_pd(r), r.random(SHAPE).astype(np.float32)),
    "logdet": lambda r: (_pd(r),),
    "herm_apply": lambda r: (_pd(r), _c(r), _c(r)),
    "gen_outer": lambda r: (_c(r), _c(r), _c(r), _c(r)),
    "herm_sq": lambda r: (_pd(r),),
    "herm_as_gen": lambda r: (_pd(r),),
    "quadform": lambda r: (_pd(r), _c(r), _c(r)),
    "sandwich22": lambda r: (_c(r, SHAPE + (2, 2)), _pd(r)),
    "herm_from_mixing": lambda r: (_c(r, SHAPE + (2, 3)),),
    "inv_herm_2x2": lambda r: (_herm_complex(r),),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_herm_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    args = CASES[name](rng)
    want = getattr(jherm, name)(*[jnp.asarray(a) for a in args])
    got = getattr(therm, name)(*[torch.as_tensor(a) for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=1e-6)


def test_inverse_is_inverse():
    """inv(P) @ P == I for well-conditioned P (loading rel 1e-6)."""
    rng = np.random.default_rng(0)
    P = torch.as_tensor(_pd(rng)).double()
    prod = therm.gen_to_complex(therm.mul(therm.inv(P), P))
    eye = torch.eye(2, dtype=prod.dtype).expand_as(prod)
    assert float((prod - eye).abs().max()) < 1e-5
