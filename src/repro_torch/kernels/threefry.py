"""``jax.random``'s Threefry-2x32 draws on the card: CUDA kernel and plain
version.

The reference draws its initial weights with ``jax.random.normal`` and
QuantizedFL's rounding uniforms with ``jax.random.uniform`` inside the traced
round (``src/repro/fl/baselines/quantized.py``).  With
``jax_threefry_partitionable=True`` (the default of jax 0.9) element ``i`` of
a draw of ``n`` is the 20-round Threefry-2x32 block of the key on the count
pair ``(i >> 32, i & 0xffffffff)``, its two words xor-ed; nothing depends on
the draw's shape, so any index set of a draw is itself.  The host generator
``repro_torch.random`` reproduces that bitwise in NumPy; this module does the
same on tensors:

* ``normal_cuda`` / ``rounding_uniforms_cuda`` launch ``csrc/threefry.cu``:
  one thread a count, the erf_inv chain in explicitly rounded float32
  operations (``__fmaf_rn`` where XLA's CPU code fuses, ``__fmul_rn`` and
  friends elsewhere), so the card gives the host's bits;
* ``normal_plain`` / ``uniform_plain`` / ``rounding_uniforms_plain`` are the
  same functions in plain PyTorch on any device: the integer work in int64
  masked to 32 bits, each fused multiply-add by the float64 round-to-odd
  trick of ``repro_torch.random._fma``.  They take an explicit index set as
  well as a length, so a check can sample a 671 M-element leaf.

There is no Pallas kernel for this in the reference: XLA draws the numbers.
The kernel is the port's own; ``PERF.md`` lists it apart from the ported ones.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.kernels import build

#: launches of each kernel by its wrapper (nothing else touches them)
NORMAL_LAUNCHES = 0
ROUNDING_LAUNCHES = 0

THREADS = 256
ITEMS = 4                      # counts a thread, for instruction-level parallelism
MAX_COUNT = 1 << 32            # the counts' high word is always 0 below this

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32


def _f(c) -> float:
    """A float32 constant as the Python float that holds it exactly."""
    return float(_F32(c))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def threefry_block(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block on int64 tensors holding uint32
    values; the keys are ints or tensors that broadcast against the counts."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0, x1 = torch.broadcast_tensors(x0 + k0, x1 + k1)
    x0, x1 = x0.bitwise_and(_MASK), x1.bitwise_and(_MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            high = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_and_(_MASK).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x0, x1


def fold_in_plain(k0, k1, data) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in`` on tensors: the key(s) ``(k0, k1)`` hash the
    uint32 value(s) ``data`` as the count pair ``(0, data)``."""
    data = torch.as_tensor(data).long() & _MASK
    return threefry_block(k0, k1, torch.zeros_like(data), data)


def _counts(n: Optional[int], index: Optional[torch.Tensor], device) -> torch.Tensor:
    if (n is None) == (index is None):
        raise ValueError("give exactly one of n and index")
    if index is None:
        if not 0 <= n <= MAX_COUNT:
            raise ValueError(f"a draw of {n} elements: the counts stop at 2**32")
        return torch.arange(n, dtype=torch.int64, device=device)
    index = torch.as_tensor(index, device=device).long()
    if index.numel() and (int(index.min()) < 0 or int(index.max()) >= MAX_COUNT):
        raise ValueError("indices must lie in [0, 2**32)")
    return index


def random_bits_plain(key, n: Optional[int] = None, *, index=None,
                      device="cpu") -> torch.Tensor:
    """Elements ``range(n)`` (or ``index``) of ``_random_bits(key, 32, ·)``
    as int64 tensors holding uint32 words.  ``key`` is a (2,) key, or a
    pair of int64 tensors of key words that broadcast against the counts:
    each element then draws under its own key (many draws in one pass)."""
    if isinstance(key, tuple) and isinstance(key[0], torch.Tensor):
        k0, k1 = key
    else:
        k0, k1 = (int(v) for v in np.asarray(key, np.uint32))
    lo = _counts(n, index, device)
    b0, b1 = threefry_block(k0, k1, lo >> 32, lo & _MASK)
    return b0 ^ b1


def _floats01(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the 23 high bits: [1, 2) − 1."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as a fused multiply-add rounds it;
    ``b`` and ``c`` are float32 tensors or constants.

    The float64 product of two float32 values is exact, and the float64 sum
    rounds to float32 as the exact value does unless it lies halfway between
    two float32 values (or below their normal range).  Only those elements
    take the round-to-odd correction of ``repro_torch.random._fma``: the
    sum's TwoSum error decides its last bit."""
    b, c = (v.double() if isinstance(v, torch.Tensor) else _f(v) for v in (b, c))
    a = a.double()
    s = a * b + c
    bits = s.view(torch.int64)
    hard = (((bits & 0x1FFFFFFF) == 0x10000000)
            | ((bits & 0x7FF0000000000000) < (897 << 52))).nonzero().squeeze(1)
    out = s.float()
    if hard.numel():
        def at(v):
            if isinstance(v, torch.Tensor):
                return torch.broadcast_to(v, s.shape)[hard]
            return torch.full(hard.shape, v, dtype=torch.float64, device=s.device)

        prod, cc = at(a) * at(b), at(c)
        sh = prod + cc
        b_virt = sh - prod
        err = (prod - (sh - b_virt)) + (cc - b_virt)
        fix = (err != 0) & ((sh.view(torch.int64) & 1) == 0) & torch.isfinite(sh)
        toward = torch.where(err > 0, float("inf"), -float("inf")).double()
        out[hard] = torch.where(fix, torch.nextafter(sh, toward), sh).float()
    return out


def _logf(y: torch.Tensor) -> torch.Tensor:
    """Cephes' logf as XLA's CPU code computes it (``random._logf``)."""
    tiny = _f(1.1754944e-38)
    y = torch.where(y > tiny, y, torch.full_like(y, tiny))
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _f(0.70710677)
    e = e - low.float()
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    y1 = _fma(_fma(x, 0.070376836, -0.1151461), x, 0.116769984)
    y2 = _fma(_fma(x, -0.12420141, 0.14249323), x, -0.16668057)
    y3 = _fma(_fma(x, 0.20000714, -0.24999994), x, 0.3333333)
    r = _fma(_fma(y1, x3, y2), x3, y3)
    r = _fma(r, x3, e * _f(-0.00021219444))
    return _fma(e, 0.6933594, _fma(-x2, 0.5, x) + r)


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    """XLA's rational log1p for |x| < sqrt(2) − 1."""
    p = torch.full_like(x, _f(prng._LOG1P_P[0]))
    q = torch.full_like(x, _f(prng._LOG1P_Q[0]))
    for cp, cq in zip(prng._LOG1P_P[1:], prng._LOG1P_Q[1:]):
        p, q = _fma(p, x, cp), _fma(q, x, cq)
    x2 = x * x
    return x + _fma(x2, -0.5, (x * x2) * (p / q))


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p (``random._log1p``), each branch computed only
    where it is taken."""
    small = torch.abs(x) < _f(prng._LOG1P_SMALL)
    out = torch.empty_like(x)
    i = small.nonzero().squeeze(1)
    out[i] = _log1p_small(x[i])
    i = torch.logical_not(small).nonzero().squeeze(1)
    out[i] = _logf(x[i] + 1.0)
    return out


def _erf_inv_poly(ww: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(ww, _f(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, ww, c)
    return p


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on the CPU (``random.erf_inv``): Giles'
    polynomial in w − 2.5 below w = 5, in sqrt(w) − 3 above."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    p = torch.empty_like(x)
    i = lt.nonzero().squeeze(1)
    p[i] = _erf_inv_poly(w[i] - 2.5, prng._ERFINV_LT5)
    i = torch.logical_not(lt).nonzero().squeeze(1)
    # the float64 root rounds to the correctly rounded float32 one; PyTorch's
    # vectorised float32 sqrt on the CPU is not always correctly rounded
    p[i] = _erf_inv_poly(torch.sqrt(w[i].double()).float() - 3.0, prng._ERFINV_GE5)
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def uniform_plain(key, n: Optional[int] = None, *, index=None, minval: float = 0.0,
                  maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """Elements of ``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    floats = _floats01(random_bits_plain(key, n, index=index, device=device))
    lo, hi = _F32(minval), _F32(maxval)
    out = _fma(floats, _f(hi - lo), _f(lo))
    return torch.maximum(out, torch.tensor(_f(lo), device=out.device))


def normal_plain(key, n: Optional[int] = None, *, index=None, device="cpu") -> torch.Tensor:
    """Elements ``range(n)`` (or ``index``) of ``jax.random.normal(key, ·)``
    (float32): ``sqrt(2)·erf_inv(u)``, ``u`` uniform on (nextafter(−1, 0), 1)."""
    lo = np.nextafter(_F32(-1), _F32(0), dtype=_F32)
    u = uniform_plain(key, n, index=index, minval=lo, maxval=1.0, device=device)
    return _f(np.sqrt(2)) * erf_inv_plain(u)


def rounding_uniforms_plain(seed: int, t, ids, offsets, width: int) -> torch.Tensor:
    """QuantizedFL's (P, width) float32 rounding uniforms: row k, leaf l's
    columns are ``uniform`` draws of ``fold_in(fold_in(fold_in(PRNGKey(seed),
    t), ids[k]), l)``.  ``t``, ``ids`` and ``offsets`` (the L + 1 leaf
    offsets, ``offsets[-1] == width``) are tensors on one device."""
    ids = torch.as_tensor(ids)
    dev = ids.device
    base = prng.PRNGKey(seed)
    k0, k1 = fold_in_plain(int(base[0]), int(base[1]), torch.as_tensor(t, device=dev).reshape(()))
    k0, k1 = fold_in_plain(k0, k1, ids.reshape(-1))                          # (P,)
    offsets = torch.as_tensor(offsets, device=dev).long()
    n_leaves = offsets.numel() - 1
    l0, l1 = fold_in_plain(k0[:, None], k1[:, None],
                           torch.arange(n_leaves, device=dev)[None, :])      # (P, L)
    col = torch.arange(width, dtype=torch.int64, device=dev)
    leaf = torch.searchsorted(offsets[1:], col, right=True)                  # (width,)
    count = col - offsets[leaf]
    b0, b1 = threefry_block(l0[:, leaf], l1[:, leaf], torch.zeros_like(count), count)
    return _floats01(b0 ^ b1)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
def _key_words(key) -> Tuple[int, int]:
    k = np.asarray(key, np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is a (2,) uint32 array, got shape {k.shape}")
    return int(k[0]), int(k[1])


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{dev} is not the current device cuda:{torch.cuda.current_device()}")
    return dev


def grid_blocks(n: int) -> int:
    """Blocks of a launch over ``n`` counts (a row's width for the rounding
    uniforms, whose grid has one row of blocks per client)."""
    return -(-n // (THREADS * ITEMS))


def normal_cuda(key, n: int, device="cuda") -> torch.Tensor:
    """Elements ``range(n)`` of ``jax.random.normal(key, ·)`` (float32) on
    the card, one launch."""
    global NORMAL_LAUNCHES
    dev = _cuda_device(device)
    k0, k1 = _key_words(key)
    if not 0 <= n <= MAX_COUNT:
        raise ValueError(f"a draw of {n} elements: the counts stop at 2**32")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = build.library()
    rc = lib.flrce_threefry_normal(k0, k1, out.data_ptr(), n, grid_blocks(n),
                                   torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "threefry normal")
    NORMAL_LAUNCHES += 1
    return out


def _check_index(name: str, x: torch.Tensor, dev: torch.device) -> None:
    if x.device != dev or x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError(f"rounding_uniforms {name}: expected a contiguous int64 tensor on {dev}, "
                         f"got {x.dtype} on {x.device}")


def rounding_uniforms_cuda(seed: int, t: torch.Tensor, ids: torch.Tensor,
                           offsets: torch.Tensor, width: int) -> torch.Tensor:
    """``rounding_uniforms_plain`` on the card in one launch.  ``t`` (one
    element), ``ids`` (P,) and ``offsets`` (L + 1,) are int64 tensors on the
    card, read only by the kernel: the launch waits on nothing and can be
    captured in a CUDA graph."""
    global ROUNDING_LAUNCHES
    dev = _cuda_device(ids.device)
    for name, x in (("t", t), ("ids", ids), ("offsets", offsets)):
        _check_index(name, x, dev)
    if t.numel() != 1 or ids.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 2:
        raise ValueError(f"rounding_uniforms: t {tuple(t.shape)}, ids {tuple(ids.shape)}, "
                         f"offsets {tuple(offsets.shape)}")
    if not 0 <= width < MAX_COUNT:
        raise ValueError(f"rounding_uniforms: width {width} outside [0, 2**32)")
    p = ids.shape[0]
    out = torch.empty((p, width), dtype=torch.float32, device=dev)
    if p == 0 or width == 0:
        return out
    k0, k1 = _key_words(prng.PRNGKey(seed))
    lib = build.library()
    rc = lib.flrce_threefry_rounding(k0, k1, t.data_ptr(), ids.data_ptr(), offsets.data_ptr(),
                                     offsets.numel() - 1, out.data_ptr(), p, width,
                                     grid_blocks(width),
                                     torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "threefry rounding uniforms")
    ROUNDING_LAUNCHES += 1
    return out


def kernel_attributes() -> dict:
    """Registers and local bytes of each Threefry kernel, from the loaded
    library (``cudaFuncGetAttributes``), and resident blocks per SM."""
    lib = build.library()
    out = {}
    for which, name in ((0, "normal"), (1, "rounding")):
        regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        build.check(lib.flrce_threefry_attributes(which, ctypes.byref(regs), ctypes.byref(local),
                                                  ctypes.byref(blocks)), "threefry attributes")
        out[name] = dict(registers=regs.value, local_bytes=local.value,
                         blocks_per_sm=blocks.value, threads=THREADS, items=ITEMS)
    return out
