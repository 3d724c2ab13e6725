"""Threefry-2x32 keys in NumPy, bitwise equal to ``jax.random``.

Alg. 2 (client selection) consumes a key chain, a float32 Bernoulli flip and
a permutation, and QuantizedFL's stochastic rounding consumes uniforms keyed
by ``fold_in``; the port must draw exactly the reference's numbers, so the
generator is re-implemented here rather than replaced by ``torch.Generator``.
Only the pieces those paths consume exist:

* :func:`PRNGKey`, :func:`split` (the partitionable "fold-like" split),
  :func:`fold_in`;
* :func:`uniform` — float32 in [minval, maxval), a scalar or any shape;
* :func:`normal` — float32 standard normals (the paper models' init);
* :func:`permutation` / :func:`choice` (``replace=False``) — the sort-based
  shuffle: ``ceil(3·ln n / ln(2³²−1))`` rounds of a stable sort by fresh
  32-bit keys.

These follow ``jax._src.prng`` (``threefry_2x32``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``) and ``jax._src.random`` (``_uniform``,
``_shuffle``, ``choice``) with ``jax_threefry_partitionable=True``, the
default of jax 0.9.  A key is a ``(2,)`` uint32 array.

``normal`` is ``sqrt(2)·erf_inv(u)`` of a uniform on (-1, 1), and XLA's CPU
code for ``erf_inv`` is a rational ``log1p`` and Cephes' ``logf`` feeding
Giles' single-precision polynomial.  The compiled code contracts a product
with the sum that is its only use into one fused multiply-add, so
:func:`_fma` rounds such pairs once, as the x86-64 FMA instruction does;
every other operation is a plain float32 one, in XLA's order.  The result is
bitwise ``jax.random.normal`` on an x86-64 host with FMA (the test draws a
million values), not an approximation of the normal distribution.
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


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once, as a fused multiply-add rounds it.

    The float64 product of two float32 values is exact; the float64 sum is
    then made round-to-odd (its error term from TwoSum decides the last
    bit), so that rounding it to float32 is the single correct rounding.
    """
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float32) for v in (a, b, c)))
    prod = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    with np.errstate(all="ignore"):
        s = prod + c64
        b_virt = s - prod
        err = (prod - (s - b_virt)) + (c64 - b_virt)
        even = (s.view(np.uint64) & np.uint64(1)) == 0
        inexact_even = (err != 0) & even & np.isfinite(s)
        s = np.where(inexact_even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def uniform(key: np.ndarray, shape: Tuple[int, ...] = (), minval: float = 0.0,
            maxval: float = 1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    A scalar (``np.float32``) for ``shape=()``, else an array of ``shape``
    whose element i (row-major) comes from count i, as the reference's
    partitionable bits lay them out.  The floats in [0, 1) are scaled by
    ``maxval - minval``, shifted by ``minval`` (one fused multiply-add) and
    clamped below at ``minval``, in float32, in the reference's order.
    """
    n = math.prod(shape)
    bits = random_bits(key, n) if n else np.zeros(0, np.uint32)
    mant = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = np.maximum(lo, _fma(floats, hi - lo, lo))
    return floats[0] if shape == () else floats.reshape(shape)


# XLA's float32 log1p: Cephes' rational form below |x| < sqrt(2) - 1, its
# logf of 1 + x above (coefficients as the compiled code holds them)
_LOG1P_SMALL = np.float32(0.41421357)
_LOG1P_P = tuple(np.float32(c) for c in (4.527e-05, 0.49854103, 6.5787325, 29.911919,
                                          60.94967, 57.112965, 20.039553))
_LOG1P_Q = tuple(np.float32(c) for c in (1.0, 15.062909, 83.04757, 221.7624, 309.09872,
                                          216.42789, 60.11866))
# Giles' single-precision erf_inv polynomials for w < 5 and w >= 5
_ERFINV_LT5 = tuple(np.float32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(np.float32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _logf(y: np.ndarray) -> np.ndarray:
    """Cephes' logf for y > 0: y = m·2^e, m in [sqrt(1/2), sqrt(2))."""
    f = np.float32
    y = np.where(y > f(1.1754944e-38), y, f(1.1754944e-38)).astype(f)
    bits = y.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(f) + f(1)
    m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(f)
    low = m < f(0.70710677)
    e = e - np.where(low, f(1), f(0))
    x = (m - f(1)) + np.where(low, m, f(0))
    x2 = x * x
    x3 = x2 * x
    y1 = _fma(_fma(x, f(0.070376836), f(-0.1151461)), x, f(0.116769984))
    y2 = _fma(_fma(x, f(-0.12420141), f(0.14249323)), x, f(-0.16668057))
    y3 = _fma(_fma(x, f(0.20000714), f(-0.24999994)), x, f(0.3333333))
    r = _fma(_fma(y1, x3, y2), x3, y3)
    r = _fma(r, x3, e * f(-0.00021219444))
    return _fma(e, f(0.6933594), _fma(-x2, f(0.5), x) + r)


def _log1p(x: np.ndarray) -> np.ndarray:
    with np.errstate(all="ignore"):
        big = _logf(x + np.float32(1))
        p = np.full_like(x, _LOG1P_P[0])
        q = np.full_like(x, _LOG1P_Q[0])
        for cp, cq in zip(_LOG1P_P[1:], _LOG1P_Q[1:]):
            p, q = _fma(p, x, cp), _fma(q, x, cq)
        x2 = x * x
        small = x + _fma(x2, np.float32(-0.5), (x * x2) * (p / q))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, big)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on the CPU (±inf at ±1)."""
    x = np.asarray(x, np.float32)
    w = -_log1p(x * -x)
    lt = w < np.float32(5)
    with np.errstate(invalid="ignore"):
        ww = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, ww, np.where(lt, c_lt, c_ge).astype(np.float32))
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == np.float32(1), x * np.float32(np.inf), p * x)


def normal(key: np.ndarray, shape: Tuple[int, ...] = ()):
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2)·erf_inv(u)`` of
    ``u = uniform(key, shape, nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
    u = np.asarray(uniform(key, shape, lo, 1.0), np.float32)
    out = np.float32(np.sqrt(2)) * erf_inv(u)
    return out[()] if shape == () else out


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


__all__ = [
    "PRNGKey", "split", "fold_in", "uniform", "normal", "erf_inv", "permutation", "choice",
    "threefry_2x32",
]
