"""Synthetic federated classification data (NumPy copy of the reference).

Class-conditional Gaussians pushed through a frozen random teacher MLP, split
across clients by Dirichlet label skew.  Every array is drawn exactly as the
reference draws it, so a seed gives the reference's dataset bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.data.partition import dirichlet_label_partition


@dataclasses.dataclass
class FederatedDataset:
    """Global arrays + per-client index lists + a held-out eval split."""

    x: np.ndarray                 # (N, feature_dim) or (N, H, W, C) float32
    y: np.ndarray                 # (N,) int32
    client_indices: List[np.ndarray]
    eval_x: np.ndarray
    eval_y: np.ndarray
    num_classes: int

    def client_data(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        ix = self.client_indices[k]
        return self.x[ix], self.y[ix]

    def client_sizes(self) -> np.ndarray:
        return np.asarray([len(ix) for ix in self.client_indices])


def make_classification(
    num_samples: int = 20_000,
    num_eval: int = 2_000,
    feature_dim: int = 32,
    num_classes: int = 10,
    noise: float = 0.6,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Draw (x, y, eval_x, eval_y)."""
    rng = np.random.default_rng(seed)
    hidden = 64
    w1 = rng.normal(size=(feature_dim, hidden)).astype(np.float32) / np.sqrt(feature_dim)
    w2 = rng.normal(size=(hidden, feature_dim)).astype(np.float32) / np.sqrt(hidden)
    centers = rng.normal(size=(num_classes, feature_dim)).astype(np.float32) * 1.8

    def _draw(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        z = centers[y] + noise * rng.normal(size=(n, feature_dim)).astype(np.float32)
        x = np.tanh(z @ w1) @ w2 + 0.1 * z
        return x.astype(np.float32), y

    x, y = _draw(num_samples)
    ex, ey = _draw(num_eval)
    return x, y, ex, ey


def make_federated_classification(
    num_clients: int = 100,
    alpha: float = 0.1,
    num_samples: int = 20_000,
    num_eval: int = 2_000,
    feature_dim: int = 32,
    num_classes: int = 10,
    noise: float = 0.6,
    harmful_fraction: float = 0.0,
    seed: int = 0,
) -> FederatedDataset:
    """``harmful_fraction``: fraction of clients whose labels are permuted."""
    x, y, ex, ey = make_classification(
        num_samples, num_eval, feature_dim, num_classes, noise, seed
    )
    parts = dirichlet_label_partition(y, num_clients, alpha=alpha, seed=seed)
    if harmful_fraction > 0.0:
        rng = np.random.default_rng(seed + 777)
        n_bad = int(round(harmful_fraction * num_clients))
        bad = rng.choice(num_clients, size=n_bad, replace=False)
        perm = rng.permutation(num_classes)
        y = y.copy()
        for c in bad:
            y[parts[c]] = perm[y[parts[c]]]
    return FederatedDataset(
        x=x, y=y, client_indices=parts, eval_x=ex, eval_y=ey, num_classes=num_classes
    )


def make_image_like(
    num_clients: int = 100,
    alpha: float = 0.1,
    num_samples: int = 10_000,
    num_eval: int = 1_000,
    side: int = 16,
    channels: int = 1,
    num_classes: int = 10,
    noise: float = 0.7,
    seed: int = 0,
) -> FederatedDataset:
    """Image-shaped variant for the paper's CNN models ((N, H, W, C))."""
    feature_dim = side * side * channels
    x, y, ex, ey = make_classification(
        num_samples, num_eval, feature_dim, num_classes, noise, seed
    )
    shape = (-1, side, side, channels)
    parts = dirichlet_label_partition(y, num_clients, alpha=alpha, seed=seed)
    return FederatedDataset(
        x=x.reshape(shape),
        y=y,
        client_indices=parts,
        eval_x=ex.reshape(shape),
        eval_y=ey,
        num_classes=num_classes,
    )
