"""Attention for cached decoding, the decode half of the reference's
``src/repro/models/attention.py``: GQA projections, KV caches and one decode
step over global (full-length cache) or local (sliding-window) layers.

The step's attention is ``kernels.ops.decode_attention``: the hand-written
CUDA kernel for CUDA tensors, its plain version (the reference's
``decode_attention_jnp`` in PyTorch) for CPU tensors.  Training/prefill
attention over whole sequences and the cross-attention branch wait for a later
slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init

Params = Dict[str, torch.Tensor]


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, kv * hd, dtype),
        "wv": dense_init(gen, d, kv * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(params: Params, x: torch.Tensor, cfg: ArchConfig):
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    b, s = x.shape[:2]
    return q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd)


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype: torch.dtype,
                  device: torch.device) -> Params:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, kv, hd), dtype=dtype, device=device),
    }


def attention_decode_step(
    params: Params,
    x_t: torch.Tensor,          # (B, 1, D)
    cache: Params,
    position: int,              # index of this token
    cfg: ArchConfig,
    *,
    local: bool,
    use_rope: bool = True,
    length: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Params]:
    """One decode step.  For local blocks the cache is a ring buffer of
    ``min(window, cache_len)``; for global blocks it is full-length.

    Unlike the reference, which returns new cache arrays, the port writes this
    token's K and V into ``cache`` in place (slot ``position % cache_len``)
    and returns the same dict.  ``length`` is the (B,) int32 tensor
    ``position + 1`` on x's device; a caller running many layers makes it
    once per step.
    """
    b = x_t.shape[0]
    q, k, v = _project_qkv(params, x_t, cfg)
    if use_rope:
        pos = torch.full((b, 1), position, dtype=torch.int32, device=x_t.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    cache_len = cache["k"].shape[1]
    window = cfg.window if local else 0
    # ring buffer when the cache is sized by the window; otherwise the cache
    # is full-length and windowing (if any) is applied by masking.
    ring = bool(window) and cache_len <= window
    slot = position % cache_len
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    if length is None:
        length = torch.full((b,), position + 1, dtype=torch.int32, device=x_t.device)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], length, window=window, ring=ring)
    return out.reshape(b, 1, -1) @ params["wo"], cache
