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
are cast to fp32 as the reference casts them).  The loop runs head-major:
its state is (H, B, hd) and the four recurrent matrices sit side by side,
so a step is one batched product and the cell's elementwise work.

Both blocks carry their own projections (the config's ``d_ff`` is 0).  The
arithmetic is the reference's, operation for operation: the same
stabilisers, the same −inf mask, ``max(|nᵀq|, exp(−m))`` as the
denominator, the chunk's end state from the same terms.  The reference's
mesh arguments (``inner_axis``, ``batch_axes``) wait for ROADMAP A.9.
There is no Pallas kernel here, so the port has no CUDA kernel either.
Training differentiates the chunkwise mLSTM with autograd; the sLSTM loop
carries its derivatives written out (:class:`_SLSTMSequence`), as autograd's
graph of it costs a few hundred host operations a position.  The in-place
decode steps are for serving only.
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
    # torch.maximum, not clamp_min: at a tie it passes half the gradient to
    # each side, as the reference's jnp.maximum(m_new, -1e30) does
    m_new = torch.maximum(m_new, m_new.new_full((), -1e30))

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


def _slstm_recurrent(params: Params) -> torch.Tensor:
    """The four recurrent matrices side by side in fp32, (H, hd, 4·hd), in
    the gates' order z, i, f, o: one batched product a step gives all four
    recurrent terms, each the same hd-long dot products as four products
    would."""
    return torch.cat([params[name].float() for name in _RECURRENT], dim=-1)


def _heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(…, B, D) → (…, H, B, hd), a view."""
    *lead, b, d = t.shape
    return t.reshape(*lead, b, heads, d // heads).transpose(-3, -2)


def _slstm_cell(rec, carry, gx, keep=None):
    """One sLSTM step, head-major.  carry: (c, n, m, h_prev), each (H, B,
    hd) fp32; ``gx`` (H, B, 4·hd) the four gates' input terms side by side
    (z, i, f, o); ``rec`` from :func:`_slstm_recurrent`.  The arithmetic of
    the reference's cell, element for element: the reference's per-head
    (B, hd) layout only orders the same numbers differently.  ``keep``, a
    dict, receives the step's intermediates for :class:`_SLSTMSequence`'s
    backward pass."""
    c_prev, n_prev, m_prev, h_prev = carry
    zp, ip, fp, op = (gx + torch.bmm(h_prev, rec)).chunk(4, dim=-1)
    z = torch.tanh(zp)
    log_i = F.logsigmoid(ip)
    log_f = F.logsigmoid(fp)
    o = torch.sigmoid(op)
    a = log_f + m_prev
    m_new = torch.maximum(a, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(a - m_new)
    c = f_s * c_prev + i_s * z
    t = f_s * n_prev + i_s
    e = torch.exp(-m_new)
    n = torch.maximum(t, e)
    q = c / n
    if keep is not None:
        keep.update(ip=ip, fp=fp, z=z, o=o, a=a, log_i=log_i, i_s=i_s, f_s=f_s, t=t, e=e, n=n,
                    q=q)
    return c, n, m_new, o * q


_KEPT = ("c_prev", "h_prev", "ip", "fp", "z", "o", "a", "log_i", "i_s", "f_s", "t", "e", "n",
         "q")


def _slstm_loop(gx: torch.Tensor, rec: torch.Tensor, kept=None) -> torch.Tensor:
    """Each position's h, (S, H, B, hd), from the state c = m = h = 0, n = 1;
    ``kept``, a dict, receives for every name of ``_KEPT`` the list of each
    step's value."""
    zeros = gx.new_zeros(gx.shape[1:-1] + (gx.shape[-1] // 4,))
    carry = (zeros, torch.ones_like(zeros), zeros, zeros)
    hs = []
    for g_t in gx.unbind(0):
        keep = None if kept is None else {"c_prev": carry[0], "h_prev": carry[3]}
        carry = _slstm_cell(rec, carry, g_t, keep)
        if keep is not None:
            for name in _KEPT:
                kept.setdefault(name, []).append(keep[name])
        hs.append(carry[3])
    return torch.stack(hs)


class _SLSTMSequence(torch.autograd.Function):
    """The sLSTM over a whole sequence, its derivatives written out step by
    step.  Autograd's graph of the loop costs a few hundred host operations
    a position, and its recomputation under remat as many again; a training
    step of xlstm-1.3b runs 128 positions x 6 layers of them.  The forward
    pass is :func:`_slstm_cell`; the backward pass applies the chain rule to
    the same operations in reverse (``torch.maximum``'s split of the
    gradient, whole to the larger argument and half to each at a tie,
    included) and forms the recurrent matrices' gradient as one
    product over the sequence.  ``gx`` (S, H, B, 4·hd), ``rec`` (H, hd,
    4·hd) → (S, H, B, hd), each position's h."""

    @staticmethod
    def forward(ctx, gx, rec):
        kept = {}
        out = _slstm_loop(gx, rec, kept)
        ctx.save_for_backward(rec, *(torch.stack(kept[name]) for name in _KEPT))
        return out

    @staticmethod
    def backward(ctx, g_out):
        rec, c_prev, h_prev, ip, fp, z, o, a, log_i, i_s, f_s, t, e, n, q = ctx.saved_tensors
        # what does not depend on the incoming gradient, for the whole
        # sequence at once: the activations' derivatives and each
        # maximum's share of the gradient to its first argument (1, ½ at a
        # tie, 0), whose complement is the second's
        d_z = 1 - z * z
        d_i, d_f = torch.sigmoid(-ip), torch.sigmoid(-fp)
        d_o = (1 - o) * o
        w_t = torch.where(t > e, 1.0, torch.where(t == e, 0.5, 0.0))
        w_a = torch.where(a > log_i, 1.0, torch.where(a == log_i, 0.5, 0.0))
        steps = ip.shape[0]
        per_step = [x.unbind(0) for x in (c_prev, z, o, i_s, f_s, e, n, q, d_z, d_i, d_f, d_o,
                                          w_t, w_a)]
        rec_t = rec.transpose(1, 2)
        g_pre = [None] * steps
        g_h = g_out[-1]
        g_c = g_n = g_m = None
        for s in range(steps - 1, -1, -1):
            c0, zs, os_, is_, fs, es, ns, qs, dz, di, df, do, wt, wa = (x[s] for x in per_step)
            if s < steps - 1:
                g_h = g_out[s] + g_h
            g_o = g_h * qs
            g_q = g_h * os_
            g_c = g_q / ns if g_c is None else g_c + g_q / ns
            g_n = -(g_q * qs / ns) if g_n is None else g_n - g_q * qs / ns
            g_t = g_n * wt                                        # n = maximum(t, e)
            g_e = g_n - g_t
            g_m = -(g_e * es) if g_m is None else g_m - g_e * es
            g_fs = (g_t * per_step[6][s - 1] if s else g_t) + g_c * c0   # n starts at 1
            g_is = g_t + g_c * zs
            g_li = g_is * is_
            g_a = g_fs * fs
            g_m = g_m - g_li - g_a
            g_a_max = g_m * wa                                    # m = maximum(a, log_i)
            g_li = g_li + (g_m - g_a_max)
            g_a = g_a + g_a_max
            g_pre[s] = torch.cat([g_c * is_ * dz, g_li * di, g_a * df, g_o * do], dim=-1)
            g_c, g_n, g_m = g_c * fs, g_t * fs, g_a               # to the step before
            g_h = torch.bmm(g_pre[s], rec_t)
        g_pre = torch.stack(g_pre)                                 # (S, H, B, 4·hd)
        g_rec = None
        if ctx.needs_input_grad[1]:                                # frozen under LoRA
            heads, b = g_pre.shape[1:3]
            g_rec = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(heads, -1, steps * b),
                              g_pre.permute(1, 0, 2, 3).reshape(heads, steps * b, -1))
        return (g_pre if ctx.needs_input_grad[0] else None), g_rec


def apply_slstm(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Sequential sLSTM over (B, S, D), a step a position.  The gates'
    input terms are laid out once as (S, H, B, 4·hd), so a step takes one
    slice, one batched recurrent product and the cell's elementwise work;
    under autograd the loop runs as :class:`_SLSTMSequence`."""
    b, s, d = x.shape
    heads = cfg.num_heads
    gx = torch.cat([_heads_first(g.transpose(0, 1), heads)
                    for g in _slstm_inputs(params, x.float())], dim=-1).contiguous()
    rec = _slstm_recurrent(params)
    if torch.is_grad_enabled() and (gx.requires_grad or rec.requires_grad):
        hs = _SLSTMSequence.apply(gx, rec)
    else:
        hs = _slstm_loop(gx, rec)
    return hs.permute(2, 0, 1, 3).reshape(b, s, d).to(x.dtype) @ params["wproj"]


def init_slstm_cache(cfg: ArchConfig, batch: int, device: torch.device) -> Params:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.ones((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32), "h": torch.zeros((batch, d), **f32)}


def slstm_decode_step(params: Params, x_t: torch.Tensor, cache: Params,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, Params]:
    """One-token sLSTM step, x_t (B, 1, D).  The cache's c, n, m and h are
    updated in place; the same dict is returned."""
    heads = cfg.num_heads
    gx = torch.cat([_heads_first(g, heads) for g in _slstm_inputs(params, x_t[:, 0].float())],
                   dim=-1)
    state = tuple(_heads_first(cache[k], heads) for k in ("c", "n", "m", "h"))
    for old, new in zip(state, _slstm_cell(_slstm_recurrent(params), state, gx)):
        old.copy_(new)
    return cache["h"][:, None, :].to(x_t.dtype) @ params["wproj"], cache
