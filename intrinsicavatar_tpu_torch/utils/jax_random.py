"""The JAX package's random key path in numpy: ``PRNGKey``, ``split``,
``fold_in``, ``uniform`` and ``normal`` of ``jax.random`` with its default
``threefry2x32`` generator in its partitionable form (JAX's default), so
that the port draws a seeded initialization as the JAX package does,
without JAX.

``uniform`` is bit-equal to ``jax.random.uniform`` (its scale and shift one
fused multiply-add, as XLA computes it on a CPU); ``normal`` runs XLA's
single-precision ``erf_inv`` polynomial and lands within a few ulp of
``jax.random.normal`` (``log1p`` and the polynomial's products round
apart)."""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0,
    x1)`` (uint32 arrays) under ``key`` (2 uint32)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r)
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _hash_iota(key, n):
    """The hash of the 64-bit counters 0..n-1 (high words 0)."""
    return threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` keys."""
    return np.stack(_hash_iota(key, num), -1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    n = int(np.prod(shape))
    b0, b1 = _hash_iota(key, n)
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # one rounding of f * (hi - lo) + lo: the product is exact in float64
    out = _f32(f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo))
    return np.maximum(lo, out).reshape(shape)


# XLA's single-precision erf_inv (Giles): the coefficients for w < 5 and
# for w >= 5, highest order first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x):
    w = _f32(-np.log1p(-(x * x).astype(np.float64)))
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    coef = lambda i: np.where(lt, np.float32(_ERFINV_LT5[i]),
                              np.float32(_ERFINV_GE5[i]))
    p = coef(0)
    for i in range(1, 9):
        p = _f32(coef(i).astype(np.float64) + p.astype(np.float64)
                 * w.astype(np.float64))
    return (p * x).astype(np.float32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erf_inv of a
    uniform draw in (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return (np.float32(np.sqrt(2)) * _erf_inv(uniform(key, shape, lo, 1.0))
            ).astype(np.float32)
