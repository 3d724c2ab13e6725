"""Dirichlet label-skew partitioning (paper §4.1), a NumPy copy of the
reference's ``dirichlet_label_partition`` — the same draws in the same
order, so every client index array is bitwise the reference's."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_label_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float = 0.1,
    seed: int = 0,
    min_size: int = 2,
) -> List[np.ndarray]:
    """Split sample indices by Dir_y(alpha) label-skew. Returns index arrays."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    for _attempt in range(100):
        idx_by_client: List[list] = [[] for _ in range(num_clients)]
        for y in range(num_classes):
            idx_y = np.flatnonzero(labels == y)
            rng.shuffle(idx_y)
            props = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_y)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_y, cuts)):
                idx_by_client[client].extend(part.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_size:
            break
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in idx_by_client]
