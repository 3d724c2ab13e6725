"""Client selection (paper §3.2, Algorithm 2), bitwise the reference's.

Explore-exploit: with probability ``phi_t = decay**t`` the server explores (a
uniform sample of P clients without replacement), otherwise it exploits the
top-P clients by heuristic value.  The key chain, the Bernoulli flip and the
permutation are the reference's Threefry draws (``repro_torch.random``), so
both packages select the same clients from the same seed.

The compiled driver splits Alg. 2 in two.  The draws depend only on the key
and the round, never on device state, so the host makes them per chunk
(:func:`explore_draws`); the exploit top-P reads the device heuristic inside
the chunk (:func:`select_clients_device`).
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch import random


def explore_probability(t: int, decay: float = 0.98) -> float:
    """phi_t: 1.0 at t=0, decaying by ``decay`` each round (paper §4.1)."""
    return float(decay) ** int(t)


def select_clients(
    rng: np.ndarray,
    heuristic: Union[torch.Tensor, np.ndarray],
    t: int,
    p: int,
    decay: float = 0.98,
) -> Tuple[np.ndarray, bool]:
    """Algorithm 2.  Returns (sorted selected ids (p,), exploited).

    The flip compares a float32 uniform with ``phi`` rounded to float32, as
    the reference's weakly typed ``uniform(key) < phi`` does.  Exploit ties
    break by client id: a stable host sort on ``(-H, id)``.
    """
    if isinstance(heuristic, torch.Tensor):
        heuristic = heuristic.detach().cpu().numpy()
    h = np.asarray(heuristic, np.float32)
    m = h.shape[0]
    if p > m:
        raise ValueError(f"cannot select P={p} from M={m} clients")
    rng_flip, rng_perm = random.split(rng)
    phi = np.float32(explore_probability(t, decay))
    if random.uniform(rng_flip) < phi:
        ids = random.choice(rng_perm, m, p, replace=False)
        return np.sort(ids).astype(np.int64), False
    order = np.lexsort((np.arange(m), -h))
    return np.sort(order[:p]).astype(np.int64), True


def explore_draws(rng: np.ndarray, t: int, n: int, p: int, decay: float = 0.98
                  ) -> Tuple[bool, np.ndarray]:
    """The host half of :func:`select_clients` over ``n`` candidates:
    ``(explore, sorted explore ids (p,))``.  The permutation is drawn on
    exploit rounds too, as the reference's device selection draws it."""
    if p > n:
        raise ValueError(f"cannot select P={p} from {n} candidates")
    rng_flip, rng_perm = random.split(rng)
    phi = np.float32(explore_probability(t, decay))
    explore = bool(random.uniform(rng_flip) < phi)
    return explore, np.sort(random.choice(rng_perm, n, p, replace=False)).astype(np.int64)


def select_clients_device(
    explore: torch.Tensor,        # () bool — the host's Bernoulli flip
    explore_ids: torch.Tensor,    # (p,) int64 — the host's sorted explore draw
    heuristic: torch.Tensor,      # (n,) H over the candidates
    p: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device half of Alg. 2, with no host sync: ``(sorted ids (p,)
    int64, exploited () bool)``.  The exploit branch takes the first P of a
    stable sort on −H, so ties go to the lower index, as ``lax.top_k`` and
    the host's ``(-H, id)`` lexsort break them (``torch.topk`` promises no
    order among ties on CUDA)."""
    n = heuristic.shape[0]
    if p > n:
        raise ValueError(f"cannot select P={p} from {n} candidates")
    top = torch.sort(-heuristic, stable=True).indices[:p]
    exploit_ids = torch.sort(top).values
    return torch.where(explore, explore_ids, exploit_ids), torch.logical_not(explore)


def select_clients_device_candidates(
    explore: torch.Tensor,
    explore_slots: torch.Tensor,  # (p,) sorted slots of the host's explore draw over P_cand
    heuristic: torch.Tensor,      # (M,) H over all clients
    cand: torch.Tensor,           # (P_cand,) sorted candidate ids
    p: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_clients_device` within a candidate set: ``(slots (p,),
    exploited)``, the ids being ``cand[slots]``.  With every client a
    candidate the slots are the ids the unrestricted draw picks."""
    if p > cand.shape[0]:
        raise ValueError(f"cannot select P={p} from P_cand={cand.shape[0]} candidates")
    return select_clients_device(explore, explore_slots, heuristic[cand], p)
