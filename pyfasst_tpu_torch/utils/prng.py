"""The JAX package's random draws, in NumPy.

The JAX package draws every random init with ``jax.random`` (threefry2x32,
20 rounds, with ``jax_threefry_partitionable`` on, the default of JAX
0.9). This module computes the same bits with NumPy, so that the port,
given the same seed, starts from the same numbers as the JAX package on
every device. A key is a (2,) uint32 array, as ``jax.random.PRNGKey``
returns; ``split`` returns an (n, 2) array whose rows are keys.

    PRNGKey(seed)                    jax/_src/prng.py threefry_seed
    split(key, n)                    _threefry_split_foldlike
    fold_in(key, data)               _threefry_fold_in
    random_bits(key, bits, shape)    _threefry_random_bits_partitionable
    uniform(key, shape, dtype, ...)  jax/_src/random.py _uniform
    key_data(key)                    jax.random.key_data

Seeds are taken in [0, 2**31), where 32- and 64-bit JAX agree.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under the key
    (k1, k2); uint32 arrays of one shape in and out."""
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


def PRNGKey(seed: int) -> np.ndarray:
    """The key jax.random.PRNGKey(seed) holds: the seed's two 32-bit
    words, high first."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def key_data(key) -> np.ndarray:
    """The raw (2,) uint32 words of a key."""
    return np.asarray(key, _U32)


def _hash_iota(key, shape: Sequence[int]):
    """threefry over a uint64 iota of `shape`, split into its high and
    low words (prng.iota_2x32_shape)."""
    n = int(np.prod(shape, dtype=np.int64))
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(_U32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(_U32)
    key = key_data(key)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1.reshape(tuple(shape)), b2.reshape(tuple(shape))


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) uint32: jax.random.split(key, num)."""
    b1, b2 = _hash_iota(key, (int(num),))
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data): the key hashed with the counters
    (0, data)."""
    key = key_data(key)
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([b1, b2])


def random_bits(key, bit_width: int, shape: Sequence[int]) -> np.ndarray:
    """32- or 64-bit random words of `shape`."""
    b1, b2 = _hash_iota(key, shape)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _fma64(a, b, c):
    """a * b + c in float64 with one rounding (in all but ties of the
    last bit): Dekker's exact product and Knuth's exact sum."""
    p = a * b
    ta, tb = 134217729.0 * a, 134217729.0 * b
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl     # a*b = p + e
    s = p + c
    v = s - p
    t = (p - (s - v)) + (c - v)                           # p+c = s + t
    return s + (t + e)


def uniform(key, shape: Sequence[int] = (), dtype=np.float32,
            minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """jax.random.uniform: U[minval, maxval) of `shape` in float32 or
    float64, from the mantissa of the key's random words. The scale and
    shift are one fused multiply-add, as XLA's CPU compiler fuses them."""
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        bits, shift, one = random_bits(key, 32, shape), 9, np.uint32
    elif dtype == np.float64:
        bits, shift, one = random_bits(key, 64, shape), 12, np.uint64
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    unit = np.array(1.0, dtype).view(one)
    floats = ((bits >> one(shift)) | unit).view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    if dtype == np.float32:     # the float64 product of two floats is exact
        out = (floats.astype(np.float64) * np.float64(hi - lo)
               + np.float64(lo)).astype(np.float32)
    else:
        out = _fma64(floats, hi - lo, lo)
    return np.maximum(lo, out).reshape(tuple(shape))
