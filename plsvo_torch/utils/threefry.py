"""JAX's default random numbers, in numpy.

`jax.random` with the partitionable Threefry-2x32 generator: `prng_key`,
`split`, `random_bits` and `randint` give the same numbers as
`jax.random.PRNGKey`, `split`, `bits` and `randint` (int32, minval 0),
without JAX. The port uses them where it must draw what the JAX package
draws: the LBD binarization pairs (`ops.line_descriptor`) and, for runs
that start from the reference's bootstrap, the RANSAC hypotheses
(`reference_ransac_draws`). tests/test_torch_reference_draws.py holds them
against jax.random.
"""
from __future__ import annotations

import numpy as np


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    the key (k1, k2), in uint32 numpy arithmetic."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in rot[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[1] ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32."""
    return np.asarray([0, seed], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    hi, lo = threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                         np.arange(num, dtype=np.uint32))
    return np.stack([hi, lo], -1)


def random_bits(key, n: int) -> np.ndarray:
    """n uint32 words of jax.random.bits(key, (n,))."""
    hi, lo = threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return np.bitwise_xor(hi, lo)


def randint(key, n: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, (n,), 0, maxval) (int32) as int64: 32 bits of
    each half of the split key, reduced modulo the span as randint reduces
    them."""
    k_hi, k_lo = split(key)
    hi, lo = random_bits(k_hi, n), random_bits(k_lo, n)
    span = np.uint32(max(maxval, 1))
    with np.errstate(over="ignore"):
        mult = np.uint32(65536) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return off.astype(np.int64)


def reference_ransac_draws(n_valid, n_hyp, seed=0):
    """The JAX package's bootstrap RANSAC draws:
    `jax.random.randint(PRNGKey(seed), (n_hyp, 4), 0, n_valid)`. A
    `ransac_draws` callable for FrameHandlerMono, so that a port run can
    start from the reference's bootstrap."""
    return randint(prng_key(seed), n_hyp * 4, n_valid).reshape(n_hyp, 4)
