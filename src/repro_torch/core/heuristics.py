"""Heuristic values (paper Eq. 7): importance = row-sum of the relationship map."""
from __future__ import annotations

import torch


def heuristic_from_omega(omega: torch.Tensor) -> torch.Tensor:
    """H[k] = sum_{j != k} Ω[k, j]  (Eq. 7); the diagonal is masked out."""
    m = omega.shape[0]
    off_diag = omega * (1.0 - torch.eye(m, dtype=omega.dtype, device=omega.device))
    return torch.sum(off_diag, dim=1)


def update_heuristic_rows(h: torch.Tensor, omega: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Recompute H only for the refreshed rows (Alg. 4 line 17), O(K·M).

    Each row's own diagonal entry is zeroed before the sum, as the masked
    full recompute does.  Returns a new tensor.
    """
    sub = omega[rows]                                # (K, M), a copy
    k = sub.shape[0]
    # a device tensor of values: a Python scalar would be copied from the
    # host, a sync the compiled driver's chunks may not make
    sub[torch.arange(k, device=sub.device), rows] = sub.new_zeros(k)
    out = h.clone()
    out[rows] = torch.sum(sub, dim=1)
    return out
