"""Threefry-2x32 keys in NumPy, bitwise equal to ``jax.random``.

Alg. 2 (client selection) consumes a key chain, a float32 Bernoulli flip and
a permutation, and QuantizedFL's stochastic rounding consumes uniforms keyed
by ``fold_in``; the port must draw exactly the reference's numbers, so the
generator is re-implemented here rather than replaced by ``torch.Generator``.
Only the pieces those paths consume exist:

* :func:`PRNGKey`, :func:`split` (the partitionable "fold-like" split),
  :func:`fold_in`;
* :func:`uniform` — float32 in [0, 1), a scalar or any shape;
* :func:`permutation` / :func:`choice` (``replace=False``) — the sort-based
  shuffle: ``ceil(3·ln n / ln(2³²−1))`` rounds of a stable sort by fresh
  32-bit keys.

These follow ``jax._src.prng`` (``threefry_2x32``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``) and ``jax._src.random`` (``_uniform``,
``_shuffle``, ``choice``) with ``jax_threefry_partitionable=True``, the
default of jax 0.9.  A key is a ``(2,)`` uint32 array.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32_MAX = 0xFFFFFFFF


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The 20-round Threefry-2x32 block function on uint32 count pairs."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counts(n: int):
    """The (hi, lo) uint32 halves of a flat 64-bit iota of length n."""
    idx = np.arange(max(n, 1), dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**31."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return np.array([0, seed], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: a (num, 2) uint32 array of keys."""
    hi, lo = _counts(num)
    b0, b1 = threefry_2x32(key, hi, lo)
    return np.stack([b0[:num], b1[:num]], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: hash the uint32 ``data`` into a key.

    The reference seeds a key ``[0, data]`` from the 32-bit value and hashes
    it as one count pair under ``key``.
    """
    d = np.uint32(int(data) & _U32_MAX)
    b0, b1 = threefry_2x32(key, np.array([0], np.uint32), np.array([d], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(key: np.ndarray, n: int) -> np.ndarray:
    """n uint32 words, as ``_random_bits(key, 32, (n,))`` draws them."""
    hi, lo = _counts(n)
    b0, b1 = threefry_2x32(key, hi, lo)
    return (b0 ^ b1)[:n]


def uniform(key: np.ndarray, shape: Tuple[int, ...] = ()):
    """``jax.random.uniform(key, shape)``: float32 in [0, 1).

    A scalar (``np.float32``) for ``shape=()``, else an array of ``shape``
    whose element i (row-major) comes from count i, as the reference's
    partitionable bits lay them out.
    """
    n = math.prod(shape)
    bits = random_bits(key, n) if n else np.zeros(0, np.uint32)
    mant = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    return floats[0] if shape == () else floats.reshape(shape)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` (int32)."""
    x = np.arange(n, dtype=np.int32)
    num_rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_U32_MAX)))
    for _ in range(num_rounds):
        key, subkey = split(key)
        sort_keys = random_bits(subkey, n)
        x = x[np.argsort(sort_keys, kind="stable")]
    return x


def choice(key: np.ndarray, n: int, size: int, replace: bool = False) -> np.ndarray:
    """``jax.random.choice(key, n, shape=(size,), replace=False)``."""
    if replace:
        raise ValueError("only replace=False is supported")
    if size > n:
        raise ValueError(f"cannot take {size} samples from {n} without replacement")
    return permutation(key, n)[:size]


__all__ = ["PRNGKey", "split", "fold_in", "uniform", "permutation", "choice", "threefry_2x32"]
