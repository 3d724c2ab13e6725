"""Early-stopping criterion ES (paper §3.3, Algorithm 3).

On exploit rounds the server counts ordered conflicting pairs (negative
cosine) among the selected clients' fresh updates, divides by P, and stops
when that average reaches ψ.  The signs are read from the raw Gram U Uᵀ
(the ``gram`` kernel): dividing by positive norms cannot change a sign, so
they equal the reference's normalized-Gram signs except within rounding of 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distributed import conflict_pairs_from_gram
from repro_torch.kernels import ops as kops


class ESDecision(NamedTuple):
    stop: bool
    conflicts: float          # average conflicting peers per selected client
    conflict_pairs: int       # ordered conflicting pairs (== conflicts * p)


def conflict_pairs(updates: torch.Tensor) -> torch.Tensor:
    """``|{(k, j) : k != j, cossim(u_k, u_j) < 0}|`` for (P, D) updates, as an
    integer-valued fp32 scalar."""
    return conflict_pairs_from_gram(kops.gram(updates.float().contiguous()))


def decide_from_pairs(pairs, p: int, psi: float) -> ESDecision:
    """Alg. 3 lines 20-23 from the exact ordered-pair count."""
    n_pairs = int(pairs)
    avg = n_pairs / p
    return ESDecision(stop=avg >= psi, conflicts=avg, conflict_pairs=n_pairs)


def should_stop(updates: torch.Tensor, psi: float, *, is_exploit_round: bool) -> ESDecision:
    """Algorithm 3 over (P, D) fresh updates; explore rounds never stop and
    never compute the Gram."""
    if not is_exploit_round:
        return ESDecision(stop=False, conflicts=0.0, conflict_pairs=0)
    return decide_from_pairs(conflict_pairs(updates), updates.shape[0], psi)


def stop_count(psi: float, p: int) -> int:
    """The smallest ordered-pair count n with ``n / p >= psi`` in host float64:
    the compiled driver stops on ``pairs >= stop_count`` on the device, the
    decision :func:`decide_from_pairs` makes, with no float division there."""
    n = max(0, int(math.ceil(psi * p)))
    while n > 0 and (n - 1) / p >= psi:
        n -= 1
    while n / p < psi:
        n += 1
    return n
