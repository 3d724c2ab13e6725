"""``topk_mask_rows`` (block-local magnitude top-k, Fedcom): CUDA kernel and
plain version.

Replaces the reference's Pallas kernel ``src/repro/kernels/topk_mask.py``
``topk_mask_rows`` (``_topk_mask_kernel``); the 1-D :func:`topk_mask`
delegates to the row form, as the reference's does.  For each (row,
``block_d`` tile) of a (P, D) matrix it keeps the entries whose |u| is at
least the tile's k-th largest |u|, ``k = max(1, ceil(keep_frac · block_d))``,
and zeros the rest; D is zero-padded to a multiple of ``block_d`` and the pad
zeros take part in the last tile's threshold.  Memory-bound (each element is
read once and written once), so the kernel (``csrc/topk_mask.cu``) keeps
each tile in registers and finds its threshold by a 4-pass radix select over
8-bit digits of the magnitude bit patterns (shared-memory histograms,
warp-aggregated increments).  Its grid is one wave of resident blocks, as
the occupancy query gives it (``launch_plan``), and each block walks tiles
with a fixed stride, loading its next tile while it selects in the current
one.

``topk_mask_rows_plain`` is the same function in plain PyTorch (any dtype):
the CPU path, and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.gram import check_cuda_f32, vec_width
from repro_torch.kernels.grid import device_index, sm_count

DEFAULT_BLOCK_D = 2048
MAX_CUDA_BLOCK_D = 4096   # 256 threads × 16 register-held elements (csrc/topk_mask.cu)
THREADS = 256             # csrc/topk_mask.cu kThreads

#: launches of the kernel by its wrapper (nothing else touches it)
TOPK_MASK_LAUNCHES = 0


def keep_count(keep_frac: float, block_d: int) -> int:
    """k = max(1, ceil(keep_frac · block_d)), by the reference's expression."""
    if not 0.0 < keep_frac <= 1.0:
        raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")
    if block_d < 1:
        raise ValueError(f"block_d must be >= 1, got {block_d}")
    return max(1, int(-(-keep_frac * block_d // 1)))


def topk_mask_rows_plain(
    u: torch.Tensor, *, keep_frac: float = 0.1, block_d: int = DEFAULT_BLOCK_D
) -> torch.Tensor:
    """Row-wise block-local top-k of a (P, D) matrix; the dtype is kept."""
    k = keep_count(keep_frac, block_d)
    p, d = u.shape
    up = F.pad(u, (0, (-d) % block_d))
    blocks = up.reshape(-1, block_d)
    mag = blocks.float().abs()
    kth = torch.topk(mag, k, dim=1).values[:, k - 1]
    keep = mag >= kth[:, None]
    out = torch.where(keep, blocks, torch.zeros_like(blocks))
    return out.reshape(p, -1)[:, :d]


def items_per_thread(block_d: int) -> int:
    """Elements of a tile each of the 256 threads holds: block_d / 256
    rounded up to a power of two (the kernel's compile-time size)."""
    if not 1 <= block_d <= MAX_CUDA_BLOCK_D:
        raise ValueError(f"topk_mask_rows: block_d {block_d} not in [1, {MAX_CUDA_BLOCK_D}]")
    items = 1
    while items * THREADS < block_d:
        items *= 2
    return items


def tile_vec(block_d: int, widest: int) -> int:
    """Load width for a tile: the widest of 4, 2, 1 that is at most
    ``widest`` (what D and the pointers allow, ``gram.vec_width``), divides
    block_d and fits the thread's elements."""
    items = items_per_thread(block_d)
    return next(v for v in (4, 2, 1) if v <= widest and block_d % v == 0 and v <= items)


def plan_grid(n_tiles: int, sms: int, per_sm: int) -> int:
    """Blocks of the launch: one wave of the card's ``sms · per_sm``
    resident blocks, never more blocks than tiles."""
    if min(n_tiles, sms, per_sm) < 1:
        raise ValueError(f"plan_grid: {n_tiles} tiles, SMs={sms}, blocks per SM={per_sm}")
    return min(n_tiles, sms * per_sm)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a call is launched: ``grid`` 256-thread blocks walking ``n_tiles``
    tiles, ``blocks_per_sm`` resident on each of ``sms`` SMs, ``items``
    register-held elements a thread loaded ``vec`` at a time, ``registers``
    a thread."""
    grid: int
    n_tiles: int
    items: int
    vec: int
    blocks_per_sm: int
    sms: int
    registers: int


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, block_d: int, vec: int) -> Tuple[int, int]:
    per_sm, regs = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = build.library().flrce_topk_mask_occupancy(block_d, vec, ctypes.byref(per_sm),
                                                       ctypes.byref(regs))
    build.check(rc, "topk_mask_rows occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"topk_mask_rows: the instance (block_d {block_d}, vec {vec}) fits "
                           f"no block on an SM")
    return per_sm.value, regs.value


def launch_plan(u: torch.Tensor, out: torch.Tensor, block_d: int) -> LaunchPlan:
    """The grid the kernel gets for u (P, D) → out on the card."""
    p, d = u.shape
    vec = tile_vec(block_d, vec_width(d, u, out))
    index = device_index(u.device)
    per_sm, regs = _occupancy(index, block_d, vec)
    sms = sm_count(index)
    n_tiles = p * -(-d // block_d)
    return LaunchPlan(grid=plan_grid(n_tiles, sms, per_sm), n_tiles=n_tiles,
                      items=items_per_thread(block_d), vec=vec, blocks_per_sm=per_sm, sms=sms,
                      registers=regs)


def topk_mask_rows_cuda(
    u: torch.Tensor, *, keep_frac: float = 0.1, block_d: int = DEFAULT_BLOCK_D
) -> torch.Tensor:
    """(P, D) fp32 → (P, D) fp32 on the card."""
    global TOPK_MASK_LAUNCHES
    check_cuda_f32("topk_mask_rows u", u, 2)
    k = keep_count(keep_frac, block_d)
    if block_d > MAX_CUDA_BLOCK_D:
        raise ValueError(f"topk_mask_rows: block_d {block_d} > {MAX_CUDA_BLOCK_D}")
    p, d = u.shape
    if p < 1 or d < 1:
        raise ValueError(f"empty operand: u {tuple(u.shape)}")
    out = torch.empty_like(u)
    plan = launch_plan(u, out, block_d)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = build.library().flrce_topk_mask_rows(u.data_ptr(), out.data_ptr(), p, d, block_d, k,
                                              plan.vec, plan.grid, stream)
    build.check(rc, "topk_mask_rows")
    TOPK_MASK_LAUNCHES += 1
    return out
