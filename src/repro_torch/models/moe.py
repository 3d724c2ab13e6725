"""Mixture-of-experts MLP with top-k routing and capacity-based dispatch,
from the reference's ``src/repro/models/moe.py``.

Each token's fp32 router probabilities pick its top-k experts (ties to the
lower expert index, as ``jax.lax.top_k`` breaks them), whose gates are
renormalised to sum to one.  Tokens are dispatched in groups of ``g``
tokens (the last group padded; pad tokens take no slot): within a group,
expert e has ``capacity`` slots, filled token-major and choice-minor; a
(token, choice) past its expert's capacity is dropped, so its share of the
residual passes through and the kept gates are not renormalised again.
``apply_moe`` returns the Switch-style load-balance loss beside the
output; the decode step calls ``mix``, which leaves it out.

Two routings of a (B, S, D) batch.  By default its B·S tokens are routed
together, in groups of ``g = min(group_size, B·S)`` that cross sequences,
and the aux loss is the batch's: the reference's ``apply_moe`` on that
batch.  With ``per_sequence`` each sequence is routed alone, as the
reference's batched engine routes it (``jax.vmap`` of ``model.loss`` over
one-sequence batches, ``src/repro/fl/client.py:329-332``): groups of ``g =
min(group_size, S)`` tokens, each sequence padded on its own to a multiple
of g, capacity from that g, and the aux loss a (B,) tensor, each sequence's
own.  Both run as one pass over the batch, with no loop over sequences.

The reference moves tokens through dense one-hot dispatch and combine
tensors (G, g, E, C).  Here each kept (token, choice) gets its slot's index
in an (E, G·C, D) expert buffer: an index gather fills the buffer (exactly
the reference's dispatch, which picks one row) and another gathers each
choice's expert output back for the gated sum (the reference's combine, up
to the order of the fp32 sums).  The expert products run batched over the
experts (``torch.bmm``), and nothing waits on the device: which experts got
tokens is never read on the host, so the decode step stays free of host
reads.  The reference's sharding pins (``batch_axes``, ``expert_axis``) are
mesh work and wait for ROADMAP A.8 and A.9.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation, dense_init

Params = Dict[str, torch.Tensor]


def init_moe(key: np.ndarray, cfg: ArchConfig, dtype: torch.dtype,
             device: torch.device) -> Params:
    """The reference's ``init_moe``: of ``split(key, 4)`` the router draws
    from the first (fp32 whatever the model's dtype) and expert i's ``wi``,
    ``wg`` and ``wo`` from ``fold_in`` of the second, third and fourth.  Each
    expert is drawn straight into its row of the stacked (E, …) leaf, so the
    peak stays one expert's fp32 draw above the leaves."""
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    rr, ri, rg, ro = prng.split(key, 4)
    leaves = [("wi", ri, (d, f)), ("wo", ro, (f, d))]
    if cfg.gated_mlp:
        leaves.append(("wg", rg, (d, f)))
    params = {"router": dense_init(rr, d, e, torch.float32, device)}
    for name, leaf_key, (fan_in, fan_out) in leaves:
        w = torch.empty((e, fan_in, fan_out), dtype=dtype, device=device)
        for i in range(e):
            w[i] = dense_init(prng.fold_in(leaf_key, i), fan_in, fan_out, dtype, device)
        params[name] = w
    return params


def route(params: Params, xt: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """(fp32 router probabilities (N, E), renormalised gates (N, k), expert
    ids (N, k)) of tokens ``xt`` (N, D).  A stable descending sort keeps the
    lower expert index first among equal probabilities, as ``jax.lax.top_k``
    does."""
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert = vals[:, :k], ids[:, :k]
    gates = gates / torch.clamp_min(torch.sum(gates, dim=-1, keepdim=True), 1e-9)
    return probs, gates, expert


def slots(expert: torch.Tensor, e: int, g: int, capacity: int,
          seqs: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot (N, k), kept (N, k)) of each (token, choice) in the expert
    buffer laid out (E, groups, capacity).  The N tokens are ``seqs``
    sequences of N / seqs tokens, each padded on its own to a multiple of
    ``g`` (pad tokens route nowhere): a token's group is its sequence's
    first group plus its position // g, its place in its expert's group
    buffer the count of earlier (token, choice) pairs of that group routed
    there, token-major and choice-minor."""
    n, k = expert.shape
    s = n // seqs
    pad = (-s) % g
    per_seq = (s + pad) // g                     # groups a sequence
    ng = seqs * per_seq
    onehot = (expert[..., None] == torch.arange(e, device=expert.device)).to(torch.int32)
    onehot = onehot.reshape(seqs, s, k, e)
    if pad:                                      # pad tokens route nowhere
        onehot = torch.cat([onehot, onehot.new_zeros((seqs, pad, k, e))], dim=1)
    flat = onehot.reshape(ng, g * k, e)
    pos = torch.sum(torch.cumsum(flat, dim=1) * flat, dim=-1) - 1     # (G, g·k)
    pos = pos.reshape(seqs, s + pad, k)[:, :s].reshape(n, k)
    kept = pos < capacity
    at = torch.arange(n, device=expert.device)
    group = (at // s * per_seq + at % s // g)[:, None]
    return (expert * ng + group) * capacity + pos, kept


def experts(params: Params, expert_in: torch.Tensor, act: str) -> torch.Tensor:
    """Each expert's FFN on its buffer rows: (E, M, D) → (E, M, D), batched
    over the experts."""
    h = torch.bmm(expert_in, params["wi"])
    if "wg" in params:
        h = activation(act, torch.bmm(expert_in, params["wg"])) * h
    else:
        h = activation(act, h)
    return torch.bmm(h, params["wo"])


def mix(params: Params, x: torch.Tensor, cfg: ArchConfig, *,
        capacity_factor: Optional[float], group_size: Optional[int],
        per_sequence: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (output (B, S, D), router probabilities (N, E), expert
    ids (N, k)): routing, dispatch, the experts and the combine, without the
    load-balance loss (the decode step has no use for it).

    ``capacity_factor=None`` drops nothing (capacity = the group's tokens):
    the decode path's setting.  ``group_size`` dispatches within groups of
    that many tokens (all of a routing unit's tokens at once when None); the
    unit is the batch, or with ``per_sequence`` each sequence alone."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.num_experts, moe.top_k
    n = b * s
    xt = x.reshape(n, d)
    probs, gates, expert = route(params, xt, k)

    seqs, unit = (b, s) if per_sequence else (1, n)
    g = unit if not group_size else min(group_size, unit)
    ng = seqs * -(-unit // g)
    capacity = g if capacity_factor is None else max(1, int(capacity_factor * g * k / e))
    slot, kept = slots(expert, e, g, capacity, seqs)
    # a dropped (token, choice) points past the buffer, at a slot of its own
    # that reads zeros: every index below is written once
    buffer = e * ng * capacity
    slot = torch.where(kept, slot, buffer + torch.arange(n * k, device=x.device).reshape(n, k))
    source = torch.full((buffer + n * k,), n, dtype=torch.long, device=x.device)
    source.scatter_(0, slot.reshape(-1), torch.arange(n * k, device=x.device) // k)
    zero = xt.new_zeros((1, d))
    expert_in = torch.cat([xt, zero])[source[:buffer]].reshape(e, ng * capacity, d)

    expert_out = experts(params, expert_in, cfg.act).reshape(buffer, d)

    picked = torch.cat([expert_out, zero])[torch.clamp_max(slot, buffer)]     # (N, k, D)
    weights = gates.to(x.dtype) * kept.to(x.dtype)
    out = torch.bmm(weights[:, None, :], picked).reshape(b, s, d)
    return out, probs, expert


def aux_loss(probs: torch.Tensor, expert: torch.Tensor, cfg: ArchConfig,
             seqs: Optional[int] = None) -> torch.Tensor:
    """Switch aux loss, E · Σ_e (share of choices routed to e) · (mean router
    probability of e), the choices counted before any drop: an fp32 scalar
    over all N tokens, or with ``seqs`` a (seqs,) tensor, each sequence's
    over its own N / seqs tokens."""
    n, e = probs.shape
    b = seqs or 1
    onehot = (expert[..., None] == torch.arange(e, device=probs.device)).float()
    routed = torch.sum(onehot.reshape(b, n // b, -1, e), dim=(1, 2))          # (b, E)
    mean_probs = torch.mean(probs.reshape(b, n // b, e), dim=1)
    aux = e * torch.sum(routed / (n // b) * mean_probs, dim=-1) * cfg.moe.aux_loss_weight
    return aux if seqs else aux[0]


def apply_moe(params: Params, x: torch.Tensor, cfg: ArchConfig, *,
              capacity_factor: Optional[float] = 1.25,
              group_size: Optional[int] = None,
              per_sequence: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``apply_moe``: x (B, S, D) → (output (B, S, D), aux
    load-balance loss, fp32: a scalar, or with ``per_sequence`` a (B,)
    tensor, each sequence routed alone); ``mix`` gives the arguments'
    meaning."""
    out, probs, expert = mix(params, x, cfg, capacity_factor=capacity_factor,
                             group_size=group_size, per_sequence=per_sequence)
    return out, aux_loss(probs, expert, cfg, x.shape[0] if per_sequence else None)
