"""``cross_gram`` (U Vᵀ) and ``gram`` (U Uᵀ): CUDA kernels and plain versions.

Replace the reference's Pallas kernels ``src/repro/kernels/gram.py``
``cross_gram`` (``_xgram_kernel``) and ``gram`` (``_gram_kernel``).  Both are
memory-bound at the main path's shapes (K = 10 fresh updates against
Q = 100 stored rows over D = 595,914: 4.5 FLOP per byte read), so the
kernels (``csrc/gram.cu``) stream each input row from device memory once,
split D across blocks to fill the card, accumulate in fp32 FMA (no TF32)
and sum the per-split partials in a fixed order (bitwise repeatable).
``cross_gram`` takes two launches: the split partials, then their sums.
``gram`` with P ≤ ``MAX_TRI_ROWS`` = 16 takes one: the blocks of a one-wave
grid take 512-column slabs in turn, stream the rows' slabs by bulk copies
into a shared-memory ring and sum the upper triangle of their columns, and
the last block to arrive on an arrival counter sums the blocks' partials
and writes both halves of the square from the same values.  Larger P, or
data not 16-byte aligned, takes the cross kernel with u = v.  See the
source for the design.

``*_plain`` are the same functions in plain PyTorch: the CPU path, and the
yardstick the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grid import arrival_counters, device_index, sm_count

#: launches of each kernel by its wrapper (nothing else touches them)
CROSS_GRAM_LAUNCHES = 0
GRAM_LAUNCHES = 0
#: of GRAM_LAUNCHES, those that ran as the cross kernel (P > 16 or unaligned
#: data): on the device they are xgram_partial/sum_splits launches
GRAM_VIA_CROSS = 0

MAX_TRI_ROWS = 16      # csrc/gram.cu kMaxTriRows: above it gram takes the cross kernel
TRI_THREADS = 256      # csrc/gram.cu kTriThreads
TRI_SLAB = 512         # csrc/gram.cu kSlab: columns a block streams per stage
TRI_MIN_SLABS = 4      # each block of the one-launch kernel takes at least this many slabs


def cross_gram_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u.float() @ v.float().T


def gram_plain(u: torch.Tensor) -> torch.Tensor:
    u32 = u.float()
    return u32 @ u32.T


def check_cuda_f32(name: str, t: torch.Tensor, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous fp32 CUDA tensor of rank ``ndim``
    on the current device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.device.index is not None and t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensor on {t.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def vec_width(d: int, *tensors: torch.Tensor) -> int:
    """Widest load (4, 2 or 1 floats) that keeps every row start aligned."""
    for vec in (4, 2):
        if d % vec == 0 and all(t.data_ptr() % (4 * vec) == 0 for t in tensors):
            return vec
    return 1


def split_plan(k: int, q: int, d: int, vec: int):
    """(n_splits, chunk) from the kernel library's plan for this shape on
    the current device (one resident wave of blocks; see ``csrc/gram.cu``)."""
    lib = build.library()
    n_splits, chunk = ctypes.c_int64(), ctypes.c_int64()
    build.check(lib.flrce_xgram_plan(k, q, d, vec, ctypes.byref(n_splits), ctypes.byref(chunk)),
                "cross_gram plan")
    return n_splits.value, chunk.value


def tri_tile(p: int) -> int:
    """Rows of the one-launch kernel's compile-time tile for P rows: the
    smallest of 4, 8, 12, 16 that holds P (0 above 16: the cross kernel)."""
    if p < 1:
        raise ValueError(f"tri_tile: P={p}")
    return next((t for t in (4, 8, 12, 16) if p <= t), 0)


def plan_gram_splits(d: int, sms: int, per_sm: int) -> int:
    """Blocks of the one-launch kernel over D: at most one wave of the
    card's ``sms · per_sm`` resident blocks, each taking at least
    ``TRI_MIN_SLABS`` of the 512-column slabs where D allows (the blocks
    take the slabs in turn)."""
    if min(d, sms, per_sm) < 1:
        raise ValueError(f"plan_gram_splits: D={d}, SMs={sms}, blocks per SM={per_sm}")
    slabs = -(-d // TRI_SLAB)
    return max(1, min(sms * per_sm, slabs // TRI_MIN_SLABS))


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """How a ``gram`` call at P ≤ 16 is launched: one kernel of ``n_splits``
    blocks of ``TRI_THREADS``, taking the 512-column slabs in turn,
    ``blocks_per_sm`` of them resident on each of ``sms`` SMs, ``registers``
    a thread."""
    tile: int
    n_splits: int
    blocks_per_sm: int
    sms: int
    registers: int


@functools.lru_cache(maxsize=None)
def _tri_occupancy(index: int, tile: int) -> Tuple[int, int]:
    per_sm, regs = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = build.library().flrce_gram_occupancy(tile, ctypes.byref(per_sm), ctypes.byref(regs))
    build.check(rc, "gram occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"gram: the instance (tile {tile}) fits no block on an SM")
    return per_sm.value, regs.value


def one_launch(u: torch.Tensor) -> bool:
    """Whether ``gram`` of u takes the one-launch kernel: P ≤ 16 and the
    data 16-byte aligned (its bulk copies start at 16-byte floors)."""
    return u.shape[0] <= MAX_TRI_ROWS and u.data_ptr() % 16 == 0


def gram_plan(u: torch.Tensor) -> GramPlan:
    """The one-launch kernel's plan for u (P ≤ 16, D) on the card."""
    if not one_launch(u):
        raise ValueError(f"gram_plan: u {tuple(u.shape)} takes the two-launch cross kernel")
    p, d = u.shape
    return _gram_plan(device_index(u.device), tri_tile(p), d)


@functools.lru_cache(maxsize=1024)
def _gram_plan(index: int, tile: int, d: int) -> GramPlan:
    per_sm, regs = _tri_occupancy(index, tile)
    sms = sm_count(index)
    return GramPlan(tile=tile, n_splits=plan_gram_splits(d, sms, per_sm), blocks_per_sm=per_sm,
                    sms=sms, registers=regs)


def _check_pair(u: torch.Tensor, v: torch.Tensor) -> None:
    k, d = u.shape
    q = v.shape[0]
    if d < 1 or k < 1 or q < 1:
        raise ValueError(f"empty operand: u {tuple(u.shape)}, v {tuple(v.shape)}")
    if v.shape[1] != d:
        raise ValueError(f"dim mismatch {tuple(u.shape)} vs {tuple(v.shape)}")


def cross_gram_cuda(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(K, D) × (Q, D) → (K, Q) fp32 on the card."""
    global CROSS_GRAM_LAUNCHES
    check_cuda_f32("cross_gram u", u, 2)
    check_cuda_f32("cross_gram v", v, 2)
    if u.device != v.device:
        raise ValueError(f"cross_gram: u on {u.device}, v on {v.device}")
    _check_pair(u, v)
    (k, d), q = u.shape, v.shape[0]
    vec = vec_width(d, u, v)
    n_splits, chunk = split_plan(k, q, d, vec)
    partial = torch.empty((k, q, n_splits), dtype=torch.float32, device=u.device)
    out = torch.empty((k, q), dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = build.library().flrce_cross_gram(u.data_ptr(), v.data_ptr(), partial.data_ptr(),
                                          out.data_ptr(), k, q, d, n_splits, chunk, vec, stream)
    build.check(rc, "cross_gram")
    CROSS_GRAM_LAUNCHES += 1
    return out


def gram_cuda(u: torch.Tensor) -> torch.Tensor:
    """(P, D) → (P, P) fp32 on the card: one launch for P ≤ 16 (16-byte
    aligned data), the cross kernel's two otherwise."""
    global GRAM_LAUNCHES, GRAM_VIA_CROSS
    check_cuda_f32("gram u", u, 2)
    _check_pair(u, u)
    p, d = u.shape
    out = torch.empty((p, p), dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device)
    tri = one_launch(u)
    if tri:
        plan = gram_plan(u)
        n_splits, chunk, vec = plan.n_splits, 0, 1
        partial = torch.empty((n_splits, p * (p + 1) // 2), dtype=torch.float32, device=u.device)
        arrival = arrival_counters(u.device, stream, 1).data_ptr()
    else:
        vec = vec_width(d, u)
        n_splits, chunk = split_plan(p, p, d, vec)
        partial = torch.empty((p, p, n_splits), dtype=torch.float32, device=u.device)
        arrival = None
    rc = build.library().flrce_gram(u.data_ptr(), partial.data_ptr(), arrival, out.data_ptr(),
                                    p, d, n_splits, chunk, vec, stream.cuda_stream)
    build.check(rc, "gram")
    GRAM_LAUNCHES += 1
    GRAM_VIA_CROSS += not tri
    return out
