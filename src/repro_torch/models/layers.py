"""Shared layers of the port's language models, from the reference's
``src/repro/models/layers.py``.

Parameters are nested dicts of tensors, as in the reference; every ``init_*``
takes a host ``jax.random``-style key (``repro_torch.random``) and the device
the tensors are made on, and draws the reference's values bitwise: each
normal comes from ``kernels.ops.random_normal`` (the Threefry kernel on the
card, its plain version on the CPU), scaled in float32 and rounded to the
leaf's dtype as the reference rounds it.  Every ``apply`` is a plain
function.  Activations run in the config dtype; norms and RoPE compute in
fp32 and cast back to the input's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def normal(key: np.ndarray, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32) on ``device``."""
    return ops.random_normal(key, math.prod(shape), device).reshape(shape)


def _scaled(w: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``(f32(scale) · w).astype(dtype)``: the Python scale is a weak-typed
    float32 in the reference; the product rounds once, the cast to nearest
    even."""
    return w.mul_(float(np.float32(scale))).to(dtype)


def dense_init(key: np.ndarray, fan_in: int, fan_out: int, dtype: torch.dtype,
               device: torch.device, scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _scaled(normal(key, (fan_in, fan_out), device), scale, dtype)


def embed_init(key: np.ndarray, vocab: int, d: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return _scaled(normal(key, (vocab, d), device), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(kind: str, d: int, dtype: torch.dtype, device: torch.device) -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(f"unknown norm {kind}")


def apply_norm(kind: str, params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's plain ``x·rsqrt(var + eps)·scale`` in fp32, cast back."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(f"unknown norm {kind}")
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":  # jax.nn.gelu(approximate=True)
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name}")


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------
def init_mlp(key: np.ndarray, d: int, f: int, gated: bool, dtype: torch.dtype,
             device: torch.device) -> Params:
    r1, r2, r3 = prng.split(key, 3)
    params = {"wi": dense_init(r1, d, f, dtype, device), "wo": dense_init(r2, f, d, dtype, device)}
    if gated:
        params["wg"] = dense_init(r3, d, f, dtype, device)
    return params


def apply_mlp(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ params["wi"]
    if "wg" in params:
        h = activation(act, x @ params["wg"]) * h
    else:
        h = activation(act, h)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# temporal conv (RG-LRU block frontend; width-4 causal depthwise conv)
# ---------------------------------------------------------------------------
def init_conv1d(key: np.ndarray, d: int, width: int, dtype: torch.dtype,
                device: torch.device) -> Params:
    # normal / f32(sqrt(width)), correctly rounded: divided by a tensor, as a
    # CUDA division by a Python scalar multiplies by its reciprocal instead
    root = torch.tensor(float(np.float32(math.sqrt(width))), device=device)
    return {"w": (normal(key, (width, d), device) / root).to(dtype),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def apply_conv1d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, D): taps summed in fp32 in the
    reference's order, cast back to x's dtype."""
    width = params["w"].shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    w = params["w"].float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :].float() * w[i]
    return (out + params["b"].float()).to(x.dtype)


def conv1d_decode(params: Params, x_t: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """One-step causal conv.  x_t: (B, 1, D); tail: (B, width−1, D), the last
    inputs, shifted in place to end with x_t (the reference returns a new
    tail).  Returns (B, 1, D) in x_t's dtype."""
    window = torch.cat([tail, x_t], dim=1)                      # (B, width, D)
    out = torch.einsum("bwd,wd->bd", window.float(), params["w"].float())
    tail.copy_(window[:, 1:, :])
    return (out + params["b"].float()).to(x_t.dtype)[:, None, :]
