"""``topk_mask_rows`` (block-local magnitude top-k, Fedcom): CUDA kernel and
plain version.

Replaces the reference's Pallas kernel ``src/repro/kernels/topk_mask.py``
``topk_mask_rows`` (``_topk_mask_kernel``); the 1-D :func:`topk_mask`
delegates to the row form, as the reference's does.  For each (row,
``block_d`` tile) of a (P, D) matrix it keeps the entries whose |u| is at
least the tile's k-th largest |u|, ``k = max(1, ceil(keep_frac · block_d))``,
and zeros the rest; D is zero-padded to a multiple of ``block_d`` and the pad
zeros take part in the last tile's threshold.  Memory-bound (each element is
read once and written once), so the kernel (``csrc/topk_mask.cu``) runs one
block per tile and finds the threshold by a radix select over the magnitude
bit patterns held in registers.

``topk_mask_rows_plain`` is the same function in plain PyTorch (any dtype):
the CPU path, and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.gram import check_cuda_f32

DEFAULT_BLOCK_D = 2048
MAX_CUDA_BLOCK_D = 4096   # 256 threads × 16 register-held elements (csrc/topk_mask.cu)

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
    lib = build.library()
    out = torch.empty_like(u)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = lib.flrce_topk_mask_rows(u.data_ptr(), out.data_ptr(), p, d, block_d, k, stream)
    build.check(rc, "topk_mask_rows")
    TOPK_MASK_LAUNCHES += 1
    return out
