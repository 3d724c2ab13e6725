"""Dispatch for the port's kernels: CUDA tensors launch the hand-written
kernel, CPU tensors take its plain PyTorch version, mixed devices raise.

There is no override and no fallback: a CUDA tensor never reaches a plain
version, and a failed build or launch raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import aggregate as _aggregate
from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import threefry as _threefry
from repro_torch.kernels import topk_mask as _topk_mask

KERNELS = ("cross_gram", "gram", "weighted_aggregate", "topk_mask_rows", "decode_attention",
           "threefry_normal", "threefry_rounding")


def _device_type(name: str, *tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on different devices {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device type {kind!r}")
    return kind


def cross_gram(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(K, D) × (Q, D) → (K, Q) fp32, ``u @ v.T``."""
    if _device_type("cross_gram", u, v) == "cuda":
        return _gram.cross_gram_cuda(u, v)
    return _gram.cross_gram_plain(u, v)


def gram(u: torch.Tensor) -> torch.Tensor:
    """(P, D) → (P, P) fp32, ``u @ u.T``."""
    if _device_type("gram", u) == "cuda":
        return _gram.gram_cuda(u)
    return _gram.gram_plain(u)


def weighted_aggregate(w: torch.Tensor, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Eq. 4: ``w + p @ u`` → (D,) fp32."""
    if _device_type("weighted_aggregate", w, u, p) == "cuda":
        return _aggregate.weighted_aggregate_cuda(w, u, p)
    return _aggregate.weighted_aggregate_plain(w, u, p)


def topk_mask_rows(
    u: torch.Tensor, *, keep_frac: float = 0.1, block_d: int = _topk_mask.DEFAULT_BLOCK_D
) -> torch.Tensor:
    """Row-wise block-local magnitude top-k mask of (P, D); dtype kept."""
    if _device_type("topk_mask_rows", u) == "cuda":
        return _topk_mask.topk_mask_rows_cuda(u, keep_frac=keep_frac, block_d=block_d)
    return _topk_mask.topk_mask_rows_plain(u, keep_frac=keep_frac, block_d=block_d)


def topk_mask(
    u: torch.Tensor, *, keep_frac: float = 0.1, block_d: int = _topk_mask.DEFAULT_BLOCK_D
) -> torch.Tensor:
    """Block-local top ``ceil(keep_frac·block_d)`` magnitudes of (D,): row 0
    of the row form."""
    return topk_mask_rows(u[None, :], keep_frac=keep_frac, block_d=block_d)[0]


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length: torch.Tensor,
    *, window: int = 0, ring: bool = False,
) -> torch.Tensor:
    """One-query GQA attention of q (B, H, hd) over caches (B, S, K, hd) with
    ``length`` (B,) valid tokens: (B, H, hd) in q's dtype."""
    if _device_type("decode_attention", q, k_cache, v_cache, length) == "cuda":
        return _decode_attention.decode_attention_cuda(q, k_cache, v_cache, length,
                                                       window=window, ring=ring)
    return _decode_attention.decode_attention_plain(q, k_cache, v_cache, length,
                                                    window=window, ring=ring)


def random_normal(key, n: int, device) -> torch.Tensor:
    """Elements ``range(n)`` of ``jax.random.normal(key, ·)`` (float32, a
    host key) on ``device``: the kernel on a CUDA device, the plain version
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return _threefry.normal_cuda(key, n, dev)
    if dev.type != "cpu":
        raise ValueError(f"random_normal: unsupported device type {dev.type!r}")
    return _threefry.normal_plain(key, n, device=dev)


def rounding_uniforms(seed: int, t: torch.Tensor, ids: torch.Tensor, offsets: torch.Tensor,
                      width: int) -> torch.Tensor:
    """QuantizedFL's (P, width) float32 rounding uniforms of round ``t`` for
    clients ``ids``, leaves at ``offsets`` (L + 1 int64 values, the last one
    ``width``, which the host passes so that a CUDA call reads nothing back)."""
    if _device_type("rounding_uniforms", t, ids, offsets) == "cuda":
        return _threefry.rounding_uniforms_cuda(seed, t, ids, offsets, width)
    return _threefry.rounding_uniforms_plain(seed, t, ids, offsets, width)


def launch_counts() -> Dict[str, int]:
    """How many times each kernel's wrapper launched it since the last reset."""
    return {
        "cross_gram": _gram.CROSS_GRAM_LAUNCHES,
        "gram": _gram.GRAM_LAUNCHES,
        "weighted_aggregate": _aggregate.AGGREGATE_LAUNCHES,
        "topk_mask_rows": _topk_mask.TOPK_MASK_LAUNCHES,
        "decode_attention": _decode_attention.DECODE_ATTENTION_LAUNCHES,
        "threefry_normal": _threefry.NORMAL_LAUNCHES,
        "threefry_rounding": _threefry.ROUNDING_LAUNCHES,
    }


def reset_launch_counts() -> None:
    _gram.CROSS_GRAM_LAUNCHES = 0
    _gram.GRAM_LAUNCHES = 0
    _gram.GRAM_VIA_CROSS = 0
    _aggregate.AGGREGATE_LAUNCHES = 0
    _topk_mask.TOPK_MASK_LAUNCHES = 0
    _decode_attention.DECODE_ATTENTION_LAUNCHES = 0
    _threefry.NORMAL_LAUNCHES = 0
    _threefry.ROUNDING_LAUNCHES = 0
