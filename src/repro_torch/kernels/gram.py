"""``cross_gram`` (U Vᵀ) and ``gram`` (U Uᵀ): CUDA kernels and plain versions.

Replace the reference's Pallas kernels ``src/repro/kernels/gram.py``
``cross_gram`` (``_xgram_kernel``) and ``gram`` (``_gram_kernel``).  Both are
memory-bound at the main path's shapes (K = 10 fresh updates against
Q = 100 stored rows over D = 595,914: 4.5 FLOP per byte read), so the kernel
(``csrc/gram.cu``) streams each input row from device memory once, splits D
across blocks to fill the card, accumulates in fp32 FMA (no TF32) and sums
the per-split partials in a fixed order (bitwise-stable, no atomics).  See
the source for the design.

``*_plain`` are the same functions in plain PyTorch: the CPU path, and the
yardstick the kernels are held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of each kernel by its wrapper (nothing else touches them)
CROSS_GRAM_LAUNCHES = 0
GRAM_LAUNCHES = 0


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


def _launch_xgram(u: torch.Tensor, v: torch.Tensor, *, same: bool) -> torch.Tensor:
    k, d = u.shape
    q = v.shape[0]
    if d < 1 or k < 1 or q < 1:
        raise ValueError(f"empty operand: u {tuple(u.shape)}, v {tuple(v.shape)}")
    if v.shape[1] != d:
        raise ValueError(f"dim mismatch {tuple(u.shape)} vs {tuple(v.shape)}")
    lib = build.library()
    vec = vec_width(d, u, v)
    n_splits, chunk = split_plan(k, q, d, vec)
    partial = torch.empty((k, q, n_splits), dtype=torch.float32, device=u.device)
    out = torch.empty((k, q), dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    if same:
        rc = lib.flrce_gram(u.data_ptr(), partial.data_ptr(), out.data_ptr(),
                            k, d, n_splits, chunk, vec, stream)
    else:
        rc = lib.flrce_cross_gram(u.data_ptr(), v.data_ptr(), partial.data_ptr(),
                                  out.data_ptr(), k, q, d, n_splits, chunk, vec, stream)
    build.check(rc, "gram" if same else "cross_gram")
    return out


def cross_gram_cuda(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(K, D) × (Q, D) → (K, Q) fp32 on the card."""
    global CROSS_GRAM_LAUNCHES
    check_cuda_f32("cross_gram u", u, 2)
    check_cuda_f32("cross_gram v", v, 2)
    if u.device != v.device:
        raise ValueError(f"cross_gram: u on {u.device}, v on {v.device}")
    out = _launch_xgram(u, v, same=False)
    CROSS_GRAM_LAUNCHES += 1
    return out


def gram_cuda(u: torch.Tensor) -> torch.Tensor:
    """(P, D) → (P, P) fp32 on the card."""
    global GRAM_LAUNCHES
    check_cuda_f32("gram u", u, 2)
    out = _launch_xgram(u, u, same=True)
    GRAM_LAUNCHES += 1
    return out
