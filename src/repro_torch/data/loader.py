"""Mini-batching over in-memory client shards (NumPy copy of the reference)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def epoch_batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    rng: np.random.Generator,
    drop_remainder: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled mini-batches for one local epoch."""
    n = len(x)
    order = rng.permutation(n)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, max(stop, min(n, batch_size)), batch_size):
        ix = order[start : start + batch_size]
        if len(ix) == 0:
            break
        yield x[ix], y[ix]


def bucket_steps(s: int) -> int:
    """Round a step-axis length up to a power of two (floor 8)."""
    s = max(s, 1)
    b = 8
    while b < s:
        b <<= 1
    return b
