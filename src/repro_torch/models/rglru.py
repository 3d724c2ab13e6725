"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), from
the reference's ``src/repro/models/rglru.py``.

Recurrence (diagonal, so a scan over the sequence):

    r_t = sigmoid(x_t W_a)                      (recurrence gate)
    i_t = sigmoid(x_t W_x)                      (input gate)
    a_t = exp(c * softplus(Λ) * (-r_t))         (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

inside the Griffin recurrent block: up-projection to 1.5× width, the width-4
causal depthwise conv, RG-LRU, a GeLU-gated merge, the down-projection.  The
projections run in the model dtype; the gates, the decay and the state ``h``
in fp32 (``w_a``, ``w_x``, ``b_a``, ``b_x`` and ``lam`` are fp32 leaves in a
bf16 model, as in the reference).

Over whole sequences :func:`_scan_rglru` takes the reference's
``jax.lax.associative_scan`` as a log-depth (Hillis–Steele) scan in plain
torch ops: ⌈log2 S⌉ rounds of whole-tensor multiply-adds, where a step loop
would launch S rounds of small ones (S·18 of them a forward at
recurrentgemma-2b's depth).  Its O(S log S) elementwise work is small next
to the block's projections.  Both scans combine the same pairs
``(a1·a2, a2·b1 + b2)`` in another order, so they agree to fp32 rounding,
and so do their gradients: autograd runs back through the rounds (training;
held against ``jax.grad`` of the reference).
There is no Pallas kernel here, so the port has no CUDA kernel either.

Decode is the O(1) single-step recurrence; it updates the cache's ``h`` and
``conv_tail`` in place, as the attention layers update their KV caches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (activation, apply_conv1d, conv1d_decode, dense_init,
                                       init_conv1d)

Params = Dict[str, object]

CONV_WIDTH = 4
DECAY_C = 8.0


def _inner(cfg: ArchConfig) -> int:
    return (3 * cfg.d_model) // 2


# XLA's CPU code fully unrolls a linspace of up to this many steps and folds
# 1 − i·r into constants; a longer one runs a loop of 16-lane vectors that
# fuses it, and the unrolled remainder folds it as the short form does
_LINSPACE_UNROLLED = 352
_LINSPACE_LANES = 16


def decay_init(n: int) -> np.ndarray:
    """Λ: ``jnp.linspace(0.7, 5.0, n)`` in float32 as the reference's CPU
    code computes it (bitwise at the widths the port builds; the tests hold
    them).  The compiled HLO multiplies by r = f32(1)/f32(n − 1): out_i =
    fma(i, f32(5·r), f32(0.7·s_i)), with s_i = 1 − i·r rounded twice where
    the loop is unrolled and fused (one rounding) in the vector loop; the
    last element is 5.0."""
    f32 = np.float32
    if n == 1:
        return np.array([0.7], f32)
    i = np.arange(n - 1, dtype=f32)
    r = f32(1) / f32(n - 1)
    folded = f32(1) - i * r
    fused = prng._fma(-i, r, f32(1))
    body = 0 if n - 1 <= _LINSPACE_UNROLLED else _LINSPACE_LANES * ((n - 1) // _LINSPACE_LANES)
    s = np.concatenate([fused[:body], folded[body:]])
    out = prng._fma(i, f32(5) * r, f32(0.7) * s)
    return np.concatenate([out, [f32(5.0)]]).astype(f32)


def init_rglru(key: np.ndarray, cfg: ArchConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d, inner = cfg.d_model, _inner(cfg)
    ru, rg, ro, rc, ra, rx, _ = prng.split(key, 7)
    return {
        "w_up": dense_init(ru, d, inner, dtype, device),
        "w_gate": dense_init(rg, d, inner, dtype, device),
        "conv": init_conv1d(rc, inner, CONV_WIDTH, dtype, device),
        "w_a": dense_init(ra, inner, inner, torch.float32, device, scale=0.01),
        "w_x": dense_init(rx, inner, inner, torch.float32, device, scale=0.01),
        "b_a": torch.zeros((inner,), dtype=torch.float32, device=device),
        "b_x": torch.zeros((inner,), dtype=torch.float32, device=device),
        # Λ so that the decay a is about 0.9..0.999 at r = 1 (Griffin's init)
        "lam": torch.from_numpy(decay_init(inner)).to(device),
        "w_down": dense_init(ro, inner, d, dtype, device),
    }


def _gates(params: Params, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log a, i ⊙ u), both fp32, from the conv output u."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"] + params["b_a"])
    i = torch.sigmoid(uf @ params["w_x"] + params["b_x"])
    log_a = -DECAY_C * F.softplus(params["lam"]) * r              # (..., inner) <= 0
    return log_a, i * uf


def _input_scale(log_a: torch.Tensor) -> torch.Tensor:
    """sqrt(1 − a²), floored as the reference floors it.  The reference's
    ``jnp.maximum`` halves the gradient at a tie with the floor, ``clamp``
    does not; no fp32 input ties: 1 − exp(2·log a) is 0 or at least 2⁻²⁴."""
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))


def _scan_rglru(log_a: torch.Tensor, x_in: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t over axis 1, every prefix of the combine
    (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2), by doubling the offset."""
    a = torch.exp(log_a)
    b = _input_scale(log_a) * x_in
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)   # fold h0 into step 0
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _merge(params: Params, h: torch.Tensor, gate: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The GeLU-gated merge in fp32, cast to the model dtype, and the
    down-projection."""
    return (h * activation("gelu", gate.float())).to(dtype) @ params["w_down"]


def apply_rglru(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Griffin recurrent block over (B, S, D)."""
    u = apply_conv1d(params["conv"], x @ params["w_up"])
    gate = x @ params["w_gate"]
    log_a, gated = _gates(params, u)
    h0 = torch.zeros((x.shape[0], log_a.shape[-1]), dtype=torch.float32, device=x.device)
    return _merge(params, _scan_rglru(log_a, gated, h0), gate, x.dtype)


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    inner = _inner(cfg)
    return {
        "h": torch.zeros((batch, inner), dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((batch, CONV_WIDTH - 1, inner), dtype=dtype, device=device),
    }


def rglru_decode_step(params: Params, x_t: torch.Tensor, cache: Params,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """One-token Griffin block step, x_t (B, 1, D).  ``cache["h"]`` and
    ``cache["conv_tail"]`` are updated in place; the same dict is returned."""
    u = conv1d_decode(params["conv"], x_t @ params["w_up"], cache["conv_tail"])
    gate = x_t @ params["w_gate"]
    log_a, gated = _gates(params, u)                               # (B, 1, inner)
    h = cache["h"]
    h.mul_(torch.exp(log_a[:, 0])).add_(_input_scale(log_a[:, 0]) * gated[:, 0])
    return _merge(params, h[:, None, :], gate, x_t.dtype), cache
