"""Client selection (paper §3.2, Algorithm 2), bitwise the reference's.

Explore-exploit: with probability ``phi_t = decay**t`` the server explores (a
uniform sample of P clients without replacement), otherwise it exploits the
top-P clients by heuristic value.  The key chain, the Bernoulli flip and the
permutation are the reference's Threefry draws (``repro_torch.random``), so
both packages select the same clients from the same seed.
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
