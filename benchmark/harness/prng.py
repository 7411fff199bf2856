"""The host API's initial draw, worked out again for the reference.

A frozen copy (commit 34b280c4) of what the host API's random init needs
from pyfasst_tpu_torch/utils/prng.py: JAX's threefry2x32 bits computed
with NumPy (PRNGKey, split, 32-bit random bits, float32 uniform), and the
recipe of pyfasst_tpu_torch/models/components.py (init_inst_mixing with an
int key, init_nmf_comp) and models/variants.py (one key a source, split
from the model's key).
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x0, x1):
    k1 = np.asarray(k1, _U32).reshape(1)
    k2 = np.asarray(k2, _U32).reshape(1)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def _hash_iota(key, shape):
    n = int(np.prod(shape, dtype=np.int64))
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(_U32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(_U32)
    key = np.asarray(key, _U32)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1.reshape(tuple(shape)), b2.reshape(tuple(shape))


def split(key, num: int = 2) -> np.ndarray:
    b1, b2 = _hash_iota(key, (int(num),))
    return np.stack([b1, b2], axis=-1)


def uniform_f32(key, shape) -> np.ndarray:
    """jax.random.uniform(key, shape, float32) in [0, 1)."""
    b1, b2 = _hash_iota(key, shape)
    bits = b1 ^ b2
    unit = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | unit).view(np.float32) \
        - np.float32(1.0)
    out = (floats.astype(np.float64) * np.float64(1.0)
           + np.float64(0.0)).astype(np.float32)
    return np.maximum(np.float32(0.0), out).reshape(tuple(shape))


def host_init(seed: int, F: int, N: int, J: int, K: int, I: int = 2):
    """(A (J, I) float32, FB (J, F, K) float32, TW (J, K, N) float32): the
    initial parameters MultiChanNMFInst_FASST(..., nbComps=J,
    nbNMFComps=K, seed=seed) starts from, at rank 1 on stereo input."""
    if I != 2:
        raise ValueError("the reference draws stereo mixing only")
    thetas = (np.arange(J) + 1.0) / (J + 1.0) * (np.pi / 2)
    noise = np.random.default_rng(int(seed)).standard_normal((J, I, 1))
    A = np.stack([np.abs(np.array([[np.cos(t)], [np.sin(t)]])
                         + 0.05 * noise[j])[:, 0]
                  for j, t in enumerate(thetas)]).astype(np.float32)
    keys = split(prng_key(seed), J)
    FB, TW = [], []
    for j in range(J):
        k1, k2 = split(keys[j])
        FB.append(0.5 + uniform_f32(k1, (F, K)))
        TW.append(0.5 + uniform_f32(k2, (K, N)))
    return A, np.stack(FB), np.stack(TW)
