"""Host threefry2x32 key words, bit-equal to jax.random's default keys.

The reference keys its RNG tree with jax.random: `key(seed)`, then
`fold_in(key, pass)` per render pass and `split(key, spp)` per sample. Only
the two uint32 words of each per-sample key reach the renderer (the pcg4d
hash, ops/rng.py), so the port computes those words here in numpy and needs
no jax at render time. This follows jax 0.9 with its default
`jax_threefry_partitionable=True`: split hashes the counter pairs (0, i)
and fold_in hashes the pair (0, data).

A key is a (2,) uint32 array; a batch of keys is (n, 2).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function (20 rounds) on uint32 arrays."""
    with np.errstate(over="ignore"):
        k1, k2 = np.uint32(k1), np.uint32(k2)
        ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """Words of `jax.random.key(seed)` for a 32-bit seed: (0, seed)."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """Words of `jax.random.fold_in(k, data)`."""
    h0, h1 = threefry2x32(k[0], k[1], np.uint32(0),
                          np.uint32(int(data) & 0xFFFFFFFF))
    return np.asarray([h0, h1], np.uint32)


def split(k: np.ndarray, n: int) -> np.ndarray:
    """Words of `jax.random.split(k, n)`: (n, 2) uint32."""
    counts = np.arange(n, dtype=np.uint32)
    h0, h1 = threefry2x32(k[0], k[1], np.zeros_like(counts), counts)
    return np.stack([h0, h1], axis=-1)


__all__ = ["threefry2x32", "key", "fold_in", "split"]
