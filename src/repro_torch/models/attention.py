"""Attention blocks, from the reference's ``src/repro/models/attention.py``:
GQA projections, training/prefill attention over whole sequences, KV caches
and one decode step over global (full-length cache) or local
(sliding-window) layers.

Training and prefill attend with :func:`chunked_attention`, the reference's
online softmax over KV chunks in plain fp32 tensor ops.  The decode step's
attention is ``kernels.ops.decode_attention``: the hand-written CUDA kernel
for CUDA tensors, its plain version (the reference's
``decode_attention_jnp`` in PyTorch) for CPU tensors.  The cross-attention
branch waits for a later slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init

Params = Dict[str, torch.Tensor]

_NEG_INF = -1e30
DEFAULT_KV_CHUNK = 1024


def init_attention(key: np.ndarray, cfg: ArchConfig, dtype: torch.dtype,
                   device: torch.device) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rq, rk, rv, ro = prng.split(key, 4)
    p = {
        "wq": dense_init(rq, d, h * hd, dtype, device),
        "wk": dense_init(rk, d, kv * hd, dtype, device),
        "wv": dense_init(rv, d, kv * hd, dtype, device),
        "wo": dense_init(ro, h * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
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


# ---------------------------------------------------------------------------
# chunked (flash-style) attention over full sequences
# ---------------------------------------------------------------------------
def _chunk_attend(q, k, v, mask, scale):
    """q: (B,S,K,G,hd)  k/v: (B,C,K,hd)  mask: (B,S,C) bool -> (out, m, l)."""
    logits = torch.einsum("bskgd,bckd->bskgc", q.float(), k.float())
    logits = logits * scale
    logits = torch.where(mask[:, :, None, None, :], logits, _NEG_INF)
    m = torch.amax(logits, dim=-1)                             # (B,S,K,G)
    p = torch.exp(logits - m[..., None])
    l = torch.sum(p, dim=-1)
    out = torch.einsum("bskgc,bckd->bskgd", p, v.float())
    return out, m, l


def chunked_attention(
    q: torch.Tensor,             # (B, S, H, hd)
    k: torch.Tensor,             # (B, Skv, K, hd)
    v: torch.Tensor,
    q_positions: torch.Tensor,   # (B, S) absolute positions of queries
    kv_positions: torch.Tensor,  # (B, Skv)
    *,
    causal: bool,
    window: int = 0,
    kv_chunk: int = DEFAULT_KV_CHUNK,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk``, in fp32.
    Returns (B, S, H, hd) in q's dtype.

    KV is padded to a chunk multiple; padded positions are -1 and always
    masked.  A Python loop over the chunks takes the place of the
    reference's ``lax.scan``."""
    b, s, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, kvh, group, hd)

    pad = (-skv) % kv_chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad), value=-1)
    n_chunks = (skv + pad) // kv_chunk

    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kc, vc, pc = k[:, sl], v[:, sl], kv_positions[:, sl]
        mask = (pc >= 0)[:, None, :].expand(b, s, kv_chunk)          # (B, S, C)
        if causal:
            mask = mask & (pc[:, None, :] <= q_positions[:, :, None])
        if window > 0:
            mask = mask & (pc[:, None, :] > q_positions[:, :, None] - window)
        out_c, m_c, l_c = _chunk_attend(qg, kc, vc, mask, scale)
        if c == 0:
            # the reference merges chunk 0 into (0, -1e30, 0): alpha is 0
            # (or 1 with nothing to scale) and beta 1, which leaves chunk
            # 0's own (out, m, l)
            acc, m_run, l_run = out_c, m_c, l_c
            continue
        m_new = torch.maximum(m_run, m_c)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(m_c - m_new)
        acc = acc * alpha[..., None] + out_c * beta[..., None]
        l_run = l_run * alpha + l_c * beta
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention_block(params: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig,
                    *, local: bool) -> torch.Tensor:
    """Causal self-attention sub-block over a whole sequence, without norms
    or residual."""
    q, k, v = _project_qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    b, s = x.shape[:2]
    out = chunked_attention(q, k, v, positions, positions, causal=True,
                            window=cfg.window if local else 0)
    return out.reshape(b, s, -1) @ params["wo"]


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------
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
