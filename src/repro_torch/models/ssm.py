"""xLSTM blocks (arXiv:2405.04517), from the reference's
``src/repro/models/ssm.py``: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM is an exponentially gated matrix-memory cell.  Over whole sequences it
runs in the reference's chunkwise form: per chunk of ``chunk`` positions an
attention-like intra-chunk term (a causal (C, C) decay matrix, masked with
−inf above the diagonal) plus the state carried in from earlier chunks, each
stabilised by a running log-scale ``m``; a sequence is zero-padded to whole
chunks, as the reference's ``to_chunks`` pads it.  Decode carries the
(C, n, m) state: per head an (hd, hd) matrix memory, an (hd,) normaliser and
a scalar stabiliser (``m`` starts at −1e30), all fp32, updated in place as
the RG-LRU decode updates ``h``.  At xlstm-1.3b's width C is (B, 4, 1024,
1024) fp32 a layer.

sLSTM is a scalar-memory cell with per-head block-diagonal recurrent weights
and exponential gating: a loop over the sequence (the reference's
``lax.scan``), its gate inputs and recurrent products in fp32 (bf16 weights
are cast to fp32 as the reference casts them).

Both blocks carry their own projections (the config's ``d_ff`` is 0).  The
arithmetic is the reference's, operation for operation: the same
stabilisers, the same −inf mask, ``max(|nᵀq|, exp(−m))`` as the
denominator, the chunk's end state from the same terms.  The reference's
mesh arguments (``inner_axis``, ``batch_axes``) wait for ROADMAP A.9.
There is no Pallas kernel here, so the port has no CUDA kernel either.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, normal

Params = Dict[str, torch.Tensor]

MLSTM_EXPANSION = 2
DEFAULT_CHUNK = 256


# ===========================================================================
# mLSTM
# ===========================================================================
def init_mlstm(key: np.ndarray, cfg: ArchConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    inner = MLSTM_EXPANSION * d
    rq, rk, rv, ro, rg, ri, rf = prng.split(key, 7)
    return {
        "wq": dense_init(rq, d, inner, dtype, device),
        "wk": dense_init(rk, d, inner, dtype, device),
        "wv": dense_init(rv, d, inner, dtype, device),
        "wi": dense_init(ri, d, h, torch.float32, device, scale=0.01),
        "wf": dense_init(rf, d, h, torch.float32, device, scale=0.01),
        "bi": torch.zeros((h,), dtype=torch.float32, device=device),
        "bf": torch.full((h,), 3.0, dtype=torch.float32, device=device),   # forget-open init
        "wo": dense_init(ro, inner, d, dtype, device),
        "wgate": dense_init(rg, d, inner, dtype, device),
    }


def _mlstm_heads(cfg: ArchConfig) -> Tuple[int, int]:
    inner = MLSTM_EXPANSION * cfg.d_model
    return cfg.num_heads, inner // cfg.num_heads


def _mlstm_chunk(carry, qh, kh, vh, li, lf):
    """One chunk of the chunkwise mLSTM: carry (C (B,H,hd,hd), n (B,H,hd),
    m (B,H)); qh/kh/vh (B,H,L,hd); li/lf (B,L,H).  Returns the new carry and
    the chunk's outputs (B,H,L,hd)."""
    c_st, n_st, m_st = carry
    length = li.shape[1]
    csum_f = torch.cumsum(lf, dim=1)                          # (B,L,H) inclusive
    total_f = csum_f[:, -1]                                   # (B,H)
    a = csum_f.transpose(1, 2)                                # (B,H,L)
    # log weight of position u's input at position t: csum_f[t] + li[u] − csum_f[u]
    su = (li - lf).transpose(1, 2) - a + lf.transpose(1, 2)
    m_intra = a[..., :, None] + su[..., None, :]              # (B,H,L_t,L_u)
    tri = torch.ones((length, length), dtype=torch.bool, device=li.device).tril()
    m_intra = torch.where(tri, m_intra, -torch.inf)
    m_state = a + m_st[..., None]                             # state stabiliser + decay
    m_new = torch.maximum(torch.amax(m_intra, dim=-1), m_state)
    m_new = torch.clamp_min(m_new, -1e30)

    dmat = torch.exp(m_intra - m_new[..., None])              # (B,H,L,L)
    intra = (qh @ kh.transpose(-1, -2) * dmat) @ vh
    decay_state = torch.exp(m_state - m_new)                  # (B,H,L)
    inter = (qh @ c_st) * decay_state[..., None]
    inter_n = (qh @ n_st[..., None])[..., 0] * decay_state
    num = intra + inter                                       # (B,H,L,hd)
    den_dot = dmat @ kh
    den = torch.abs(torch.sum(qh * den_dot, dim=-1) + inter_n)
    den = torch.maximum(den, torch.exp(-m_new))               # max(|nᵀq|, 1), stabilised
    out = num / den[..., None]

    # the carried state at the chunk's end
    m_end = torch.maximum(total_f + m_st, torch.amax(su + a[..., -1:], dim=-1))
    gk = torch.exp(su + a[..., -1:] - m_end[..., None])       # (B,H,L): u's weight at the end
    keep = torch.exp(total_f + m_st - m_end)
    c_new = c_st * keep[..., None, None] + (kh * gk[..., None]).transpose(-1, -2) @ vh
    n_new = n_st * keep[..., None] + torch.sum(gk[..., None] * kh, dim=2)
    return (c_new, n_new, m_end), out


def apply_mlstm(params: Params, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Chunkwise-parallel mLSTM over (B, S, D)."""
    b, s, _ = x.shape
    h, hd = _mlstm_heads(cfg)
    pad = (-s) % chunk
    x_p = F.pad(x, (0, 0, 0, pad)) if pad else x
    nc = (s + pad) // chunk

    def heads(w):                                              # (B,S',H,hd) fp32
        return (x_p @ params[w]).reshape(b, s + pad, h, hd).float()

    q = heads("wq") / math.sqrt(hd)
    k, v = heads("wk"), heads("wv")
    xf = x_p.float()
    log_i = F.logsigmoid(xf @ params["wi"] + params["bi"])    # (B,S',H)
    log_f = F.logsigmoid(xf @ params["wf"] + params["bf"])

    carry = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device),
             torch.zeros((b, h, hd), dtype=torch.float32, device=x.device),
             torch.full((b, h), -1e30, dtype=torch.float32, device=x.device))
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        carry, out = _mlstm_chunk(carry, *(t[:, sl].transpose(1, 2) for t in (q, k, v)),
                                  log_i[:, sl], log_f[:, sl])
        outs.append(out)
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s + pad, h * hd)[:, :s]
    gate = F.silu((x @ params["wgate"]).float())
    return (out * gate).to(x.dtype) @ params["wo"]


def init_mlstm_cache(cfg: ArchConfig, batch: int, device: torch.device) -> Params:
    h, hd = _mlstm_heads(cfg)
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=torch.float32, device=device),
    }


def mlstm_decode_step(params: Params, x_t: torch.Tensor, cache: Params,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """One-token mLSTM recurrence, x_t (B, 1, D).  The cache's C, n and m are
    updated in place; the same dict is returned."""
    b = x_t.shape[0]
    h, hd = _mlstm_heads(cfg)
    xt = x_t[:, 0]
    q = (xt @ params["wq"]).reshape(b, h, hd).float() / math.sqrt(hd)
    k = (xt @ params["wk"]).reshape(b, h, hd).float()
    v = (xt @ params["wv"]).reshape(b, h, hd).float()
    xf = xt.float()
    li = F.logsigmoid(xf @ params["wi"] + params["bi"])       # (B,H)
    lf = F.logsigmoid(xf @ params["wf"] + params["bf"])
    c_st, n_st, m_st = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lf + m_st, li)
    keep = torch.exp(lf + m_st - m_new)
    gain = torch.exp(li - m_new)
    # C·keep + gain·(k ⊗ v): one pass over C to scale it, one to add the
    # rank-one term (k·gain) ⊗ v as a batched product with one inner index
    c_st.mul_(keep[..., None, None]).view(b * h, hd, hd).baddbmm_(
        (k * gain[..., None]).view(b * h, hd, 1), v.view(b * h, 1, hd))
    n_st.mul_(keep[..., None]).add_(gain[..., None] * k)
    m_st.copy_(m_new)
    num = (q[:, :, None, :] @ c_st)[:, :, 0]                  # (B,H,hd)
    den = torch.maximum(torch.abs(torch.sum(q * n_st, dim=-1)), torch.exp(-m_new))
    out = (num / den[..., None]).reshape(b, 1, h * hd)
    gate = F.silu((x_t @ params["wgate"]).float())
    return (out * gate).to(x_t.dtype) @ params["wo"], cache


# ===========================================================================
# sLSTM
# ===========================================================================
_RECURRENT = ("rz", "ri", "rf", "ro")


def init_slstm(key: np.ndarray, cfg: ArchConfig, dtype: torch.dtype,
               device: torch.device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    rz, ri, rf, ro, rr, rp = prng.split(key, 6)
    # (f32(0.1)·normal) / f32(sqrt(hd)), each rounded once, then the cast;
    # divided by a tensor: a CUDA division by a Python scalar multiplies by
    # its reciprocal instead
    root = torch.tensor(float(np.float32(math.sqrt(hd))), device=device)

    def rec(j):
        w = normal(prng.fold_in(rr, j), (h, hd, hd), device).mul_(float(np.float32(0.1)))
        return (w / root).to(dtype)

    p = {"wz": dense_init(rz, d, d, dtype, device), "wi": dense_init(ri, d, d, dtype, device),
         "wf": dense_init(rf, d, d, dtype, device), "wo_g": dense_init(ro, d, d, dtype, device)}
    p.update({name: rec(j) for j, name in enumerate(_RECURRENT)})
    p.update({
        "bz": torch.zeros((d,), dtype=torch.float32, device=device),
        "bi": torch.zeros((d,), dtype=torch.float32, device=device),
        "bf": torch.full((d,), 3.0, dtype=torch.float32, device=device),
        "bo": torch.zeros((d,), dtype=torch.float32, device=device),
        "wproj": dense_init(rp, d, d, dtype, device),
    })
    return p


def _slstm_inputs(params: Params, xf: torch.Tensor):
    """The four gates' input terms, fp32: x·W (W cast to fp32) + b."""
    return tuple(xf @ params[w].float() + params[bias]
                 for w, bias in (("wz", "bz"), ("wi", "bi"), ("wf", "bf"), ("wo_g", "bo")))


def _slstm_cell(rec, carry, zx, ix, fx, ox, heads: int):
    """One sLSTM step.  carry: (c, n, m, h_prev), each (B, D) fp32; ``rec``
    the four recurrent (H, hd, hd) matrices in fp32."""
    c_prev, n_prev, m_prev, h_prev = carry
    b, d = h_prev.shape
    hh = h_prev.reshape(b, heads, d // heads).transpose(0, 1)          # (H,B,hd)

    def recur(r):
        return (hh @ r).transpose(0, 1).reshape(b, d)

    rz, ri, rf, ro = rec
    z = torch.tanh(zx + recur(rz))
    log_i = F.logsigmoid(ix + recur(ri))
    log_f = F.logsigmoid(fx + recur(rf))
    o = torch.sigmoid(ox + recur(ro))
    m_new = torch.maximum(log_f + m_prev, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m_prev - m_new)
    c = f_s * c_prev + i_s * z
    n = torch.maximum(f_s * n_prev + i_s, torch.exp(-m_new))
    return c, n, m_new, o * (c / n)


def apply_slstm(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Sequential sLSTM over (B, S, D), a step a position."""
    b, s, d = x.shape
    zx, ix, fx, ox = _slstm_inputs(params, x.float())
    rec = tuple(params[name].float() for name in _RECURRENT)
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((b, d), **f32), torch.ones((b, d), **f32), torch.zeros((b, d), **f32),
             torch.zeros((b, d), **f32))
    hs = []
    for t in range(s):
        carry = _slstm_cell(rec, carry, zx[:, t], ix[:, t], fx[:, t], ox[:, t], cfg.num_heads)
        hs.append(carry[3])
    return torch.stack(hs, dim=1).to(x.dtype) @ params["wproj"]


def init_slstm_cache(cfg: ArchConfig, batch: int, device: torch.device) -> Params:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.ones((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32), "h": torch.zeros((batch, d), **f32)}


def slstm_decode_step(params: Params, x_t: torch.Tensor, cache: Params,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """One-token sLSTM step, x_t (B, 1, D).  The cache's c, n, m and h are
    updated in place; the same dict is returned."""
    gates = _slstm_inputs(params, x_t[:, 0].float())
    rec = tuple(params[name].float() for name in _RECURRENT)
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    for old, new in zip(state, _slstm_cell(rec, state, *gates, cfg.num_heads)):
        old.copy_(new)
    return cache["h"][:, None, :].to(x_t.dtype) @ params["wproj"], cache
