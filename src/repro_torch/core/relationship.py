"""Relationship modeling (paper §3.2, Algorithm 1) on flattened updates.

Two estimators of the relationship degree Ω[p, q] ∈ [-1, 1]:

* synchronous (Eq. 5), both updates fresh (``R[j] >= t - 1``):
  ``Ω[p, q] = cossim(u_p, u_q)``;
* asynchronous (Eq. 6), q's stored update is stale:
  ``Ω[p, q] = max(1 - orthdist(w_t + u_p, ray_q) / orthdist(w_t, ray_q), -1)``
  with ``ray_q`` from q's anchor ``a_q`` along ``u_q``.

``relationship_row`` is Algorithm 1 verbatim for one client (the oracle the
tests hold the block against).  ``relationship_block`` refreshes all K fresh
rows at once from inner products (:func:`relationship_dots`): the two
O(K·M·D) reductions go through the ``cross_gram`` kernel, the O(M·D) row
dots through plain PyTorch.  ``sketched_relationship_block`` does the same
against sketched (K_rows, D) maps and scatters the dots to the M clients
through the rows' owners.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.distributed import async_relationship_from_dots
from repro_torch.kernels import ops as kops

_EPS = 1e-12


def relationship_row(
    k: int,
    u_k: torch.Tensor,
    w_t: torch.Tensor,
    updates: torch.Tensor,      # (M, D) update map V
    anchors: torch.Tensor,      # (M, D) anchor map A
    last_rounds: torch.Tensor,  # (M,) time map R; -1 = never seen
    t: int,
    omega_row: torch.Tensor,    # (M,) previous Ω[k, :]
) -> torch.Tensor:
    """Algorithm 1: row k of Ω against every client, vectorized over j."""
    u_k = u_k.float()
    upd = updates.float()
    dots = upd @ u_k
    norms = torch.linalg.vector_norm(upd, dim=1)
    nk = torch.linalg.vector_norm(u_k)
    sync = dots / torch.clamp(norms * nk, min=_EPS)

    rel_before = w_t.float()[None, :] - anchors.float()
    rel_after = rel_before + u_k[None, :]
    vv = torch.clamp(torch.sum(upd * upd, dim=1), min=_EPS)

    def _orth(rel: torch.Tensor) -> torch.Tensor:
        coef = torch.sum(rel * upd, dim=1) / vv
        return torch.linalg.vector_norm(rel - coef[:, None] * upd, dim=1)

    d_o = _orth(rel_before)
    d_p = _orth(rel_after)
    asyncr = torch.clamp(1.0 - d_p / torch.clamp(d_o, min=_EPS), -1.0, 1.0)

    fresh = last_rounds >= (t - 1)
    seen = last_rounds >= 0
    row = torch.where(fresh, sync, asyncr)
    row = torch.where(seen, row, omega_row)
    # Ω[k, k] keeps its previous value (self-relationship excluded, Eq. 7)
    row[k] = omega_row[k]
    return row


def relationship_dots(
    u: torch.Tensor,            # (K, D) fresh updates
    w_t: torch.Tensor,          # (D,) global model at round t
    updates: torch.Tensor,      # (Q, D) update map V (rows of the fresh ids already = u)
    anchors: torch.Tensor,      # (Q, D) anchor map A
) -> Tuple[torch.Tensor, ...]:
    """The five inner-product groups Eq. 5 and Eq. 6 read, against Q rows.

    ``(uv, ur, vv, rq, rr)``: ⟨u_k, v_j⟩ and ⟨u_k, r_j⟩ (K, Q) through the
    ``cross_gram`` kernel, and ‖v_j‖², ⟨r_j, v_j⟩, ‖r_j‖² (Q,), with
    ``r_j = w_t − a_j`` formed before any product.  The reference expands
    ‖w − a_j‖² as ww − 2aw + aa (and ⟨w − a_j, ·⟩ likewise); an anchor is the
    global model of a recent round, so those terms nearly cancel: at the
    CIFAR width the expanded form put Eq. 6's fp32 entries up to 2e-3 from
    float64 on the card, the direct form under 3e-5 (``chip_smoke.py
    --numerics``).  The two forms are equal in exact arithmetic.  The row
    dots are plain reductions: ``einsum`` made each a batched product that
    took 0.77 ms at Q = 100 on the card, ten times its bytes' time.
    """
    u32 = u.float().contiguous()
    v32 = updates.float()
    r32 = w_t.float()[None, :] - anchors.float()      # (Q, D) w − a_j
    uv = kops.cross_gram(u32, v32)                    # (K, Q) ⟨u_k, v_j⟩
    ur = kops.cross_gram(u32, r32)                    # (K, Q) ⟨u_k, w − a_j⟩
    vv = torch.linalg.vector_norm(v32, dim=1).square()  # (Q,) ‖v_j‖²
    rq = (r32 * v32).sum(1)                             # (Q,) ⟨w − a_j, v_j⟩
    rr = torch.linalg.vector_norm(r32, dim=1).square()  # (Q,) ‖w − a_j‖²
    return uv, ur, vv, rq, rr


def relationship_block(
    ids: torch.Tensor,          # (K,) int64 — fresh (distinct) client ids
    u: torch.Tensor,            # (K, D) fresh updates, row-aligned with ids
    w_t: torch.Tensor,          # (D,) global model at round t
    updates: torch.Tensor,      # (M, D) update map V (rows ids already = u)
    anchors: torch.Tensor,      # (M, D) anchor map A (rows ids already = w_t)
    last_rounds: torch.Tensor,  # (M,) time map R; -1 = never seen
    t: int,
    omega_rows: torch.Tensor,   # (K, M) previous Ω rows for ids
) -> torch.Tensor:
    """Fused Algorithm 1: all K fresh rows of Ω, (K, M).

    Equal to stacking :func:`relationship_row` over ``ids`` when the maps
    already hold the fresh updates and anchors (Alg. 4 line 10 writes them
    first); the fresh self-dots ⟨u_k, u_k⟩ then come from ``uv[k, ids[k]]``.
    """
    dots = relationship_dots(u, w_t, updates, anchors)
    return rows_from_relationship_dots(ids, dots, last_rounds, t, omega_rows)


def sketched_relationship_block(
    ids: torch.Tensor,              # (K,) int64 — fresh (distinct) client ids
    u: torch.Tensor,                # (K, D) fresh updates
    w_t: torch.Tensor,              # (D,) global model at round t
    updates: torch.Tensor,          # (K_rows, D) sketched update map V
    anchors: torch.Tensor,          # (K_rows, D) sketched anchor map A
    row_owner: torch.Tensor,        # (K_rows,) int32 client owning each row; -1 empty
    last_rounds_eff: torch.Tensor,  # (M,) time map, -1 for clients without a row
    t: int,
    omega_rows: torch.Tensor,       # (K, M) previous Ω rows for ids
) -> torch.Tensor:
    """:func:`relationship_block` against K_rows-row sketched V/A maps.

    The dots are taken on the sketch (two ``cross_gram`` launches at
    Q = K_rows) and scattered to M columns through ``row_owner``.  A client
    without a row gets zero dots and ``last_rounds_eff = -1``, so its Ω
    entries keep their previous values, as for a client never seen.  The
    fresh updates and anchors must already sit in the ids' own rows.
    """
    m = last_rounds_eff.shape[0]
    # empty rows (owner -1) go to an extra column M that is cut off: -1
    # itself would address the last client
    col = torch.where(row_owner >= 0, row_owner, m).long()

    def expand(d: torch.Tensor) -> torch.Tensor:      # (..., K_rows) → (..., M)
        out = d.new_zeros((*d.shape[:-1], m + 1))
        out[..., col] = d
        return out[..., :m]

    dots = tuple(expand(d) for d in relationship_dots(u, w_t, updates, anchors))
    return rows_from_relationship_dots(ids, dots, last_rounds_eff, t, omega_rows)


def rows_from_relationship_dots(
    ids: torch.Tensor,
    dots: Sequence[torch.Tensor],   # (uv, ur, vv, rq, rr) of relationship_dots
    last_rounds: torch.Tensor,
    t: int,
    omega_rows: torch.Tensor,
) -> torch.Tensor:
    """Assemble the K fresh Ω rows from the five inner-product groups."""
    uv, ur, vv, rq, rr = dots
    k = uv.shape[0]
    arange_k = torch.arange(k, device=uv.device)
    pp = uv[arange_k, ids]                           # (K,) ⟨u_k, u_k⟩

    # synchronous rows (Eq. 5)
    norms_u = torch.sqrt(torch.clamp(pp, min=_EPS))
    norms_v = torch.sqrt(torch.clamp(vv, min=_EPS))
    sync = uv / torch.clamp(norms_u[:, None] * norms_v[None, :], min=_EPS)

    # asynchronous rows (Eq. 6) from dots
    asyncr = async_relationship_from_dots(
        uu=uv, qq=vv[None, :], rq=rq[None, :], rr=rr[None, :], ru=ur, pp=pp[:, None],
    )

    seen = last_rounds >= 0
    fresh = last_rounds >= (t - 1)
    rows = torch.where(fresh[None, :], sync, asyncr)
    rows = torch.where(seen[None, :], rows, omega_rows)
    # Ω[k, k] keeps its previous value (self-relationship excluded, Eq. 7)
    rows[arange_k, ids] = omega_rows[arange_k, ids]
    return rows
