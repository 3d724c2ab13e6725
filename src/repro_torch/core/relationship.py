"""Relationship modeling (paper §3.2, Algorithm 1) on flattened updates.

Two estimators of the relationship degree Ω[p, q] ∈ [-1, 1]:

* synchronous (Eq. 5), both updates fresh (``R[j] >= t - 1``):
  ``Ω[p, q] = cossim(u_p, u_q)``;
* asynchronous (Eq. 6), q's stored update is stale:
  ``Ω[p, q] = max(1 - orthdist(w_t + u_p, ray_q) / orthdist(w_t, ray_q), -1)``
  with ``ray_q`` from q's anchor ``a_q`` along ``u_q``.

``relationship_row`` is Algorithm 1 verbatim for one client (the oracle the
tests hold the block against).  ``relationship_block`` refreshes all K fresh
rows at once from inner products: the two O(K·M·D) reductions go through the
``cross_gram`` kernel, the O(M·D) map/model dots through plain PyTorch.
"""
from __future__ import annotations

from typing import Sequence

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
    u32 = u.float().contiguous()
    v32 = updates.float()
    a32 = anchors.float()
    w32 = w_t.float()
    uv = kops.cross_gram(u32, v32)                   # (K, M) ⟨u_k, v_j⟩
    ua = kops.cross_gram(u32, a32)                   # (K, M) ⟨u_k, a_j⟩
    uw = u32 @ w32                                   # (K,)   ⟨u_k, w⟩
    vw = v32 @ w32                                   # (M,)   ⟨v_j, w⟩
    aw = a32 @ w32                                   # (M,)   ⟨a_j, w⟩
    vv = torch.sum(v32 * v32, dim=1)                 # (M,)   ‖v_j‖²
    av = torch.sum(a32 * v32, dim=1)                 # (M,)   ⟨a_j, v_j⟩
    aa = torch.sum(a32 * a32, dim=1)                 # (M,)   ‖a_j‖²
    ww = torch.dot(w32, w32)                         #        ‖w‖²
    return rows_from_relationship_dots(
        ids, (uv, ua, uw, vw, aw, vv, av, aa, ww), last_rounds, t, omega_rows
    )


def rows_from_relationship_dots(
    ids: torch.Tensor,
    dots: Sequence[torch.Tensor],   # (uv, ua, uw, vw, aw, vv, av, aa, ww)
    last_rounds: torch.Tensor,
    t: int,
    omega_rows: torch.Tensor,
) -> torch.Tensor:
    """Assemble the K fresh Ω rows from the nine inner-product groups."""
    uv, ua, uw, vw, aw, vv, av, aa, ww = dots
    k = uv.shape[0]
    arange_k = torch.arange(k, device=uv.device)
    pp = uv[arange_k, ids]                           # (K,) ⟨u_k, u_k⟩

    # synchronous rows (Eq. 5)
    norms_u = torch.sqrt(torch.clamp(pp, min=_EPS))
    norms_v = torch.sqrt(torch.clamp(vv, min=_EPS))
    sync = uv / torch.clamp(norms_u[:, None] * norms_v[None, :], min=_EPS)

    # asynchronous rows (Eq. 6) from dots
    rq = vw - av                                     # (M,) ⟨w−a_j, v_j⟩
    rr = ww - 2.0 * aw + aa                          # (M,) ‖w−a_j‖²
    ru = uw[:, None] - ua                            # (K, M) ⟨w−a_j, u_k⟩
    asyncr = async_relationship_from_dots(
        uu=uv, qq=vv[None, :], rq=rq[None, :], rr=rr[None, :], ru=ru, pp=pp[:, None],
    )

    seen = last_rounds >= 0
    fresh = last_rounds >= (t - 1)
    rows = torch.where(fresh[None, :], sync, asyncr)
    rows = torch.where(seen[None, :], rows, omega_rows)
    # Ω[k, k] keeps its previous value (self-relationship excluded, Eq. 7)
    rows[arange_k, ids] = omega_rows[arange_k, ids]
    return rows
