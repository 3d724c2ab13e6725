"""Server-side aggregation weights (paper Eq. 4), host float64 → float32."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def aggregation_weights(sample_counts: Sequence[float]) -> np.ndarray:
    """p_k = n_k / sum n_{k'} over the selected clients (Eq. 4)."""
    n = np.asarray(sample_counts, dtype=np.float64)
    total = n.sum()
    if total <= 0:
        return np.full(len(n), 1.0 / max(1, len(n)))
    return (n / total).astype(np.float32)
