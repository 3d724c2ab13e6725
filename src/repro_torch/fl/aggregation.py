"""Server-side aggregation weights (paper Eq. 4), host float64 → float32.

``staleness_weights`` is the host-side reference of the async round's Eq. 4
weights (``fl/async_rounds.py``), which the round body computes on the device.
"""
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


def staleness_weights(sample_counts: Sequence[float], staleness: Sequence[int], decay) -> np.ndarray:
    """Staleness-weighted Eq. 4: ``p_k ∝ n_k · decay(τ_k)``, renormalized.

    With every ``τ_k == 0`` and ``decay(0) == 1.0`` the scaling multiplies by
    exactly 1.0, so the result is bitwise :func:`aggregation_weights`.
    """
    n = np.asarray(sample_counts, dtype=np.float64)
    taus = np.asarray(staleness)
    if n.shape != taus.shape:
        raise ValueError(f"sample_counts {n.shape} and staleness {taus.shape} must align")
    scaled = n * np.asarray([float(decay(int(tau))) for tau in taus], np.float64)
    total = scaled.sum()
    if total <= 0:
        return np.full(len(n), 1.0 / max(1, len(n)))
    return (scaled / total).astype(np.float32)
