"""Fedprox [21]: proximal local objective + reduced local epochs.

Computation saving comes from training fewer epochs (accuracy-relaxation
category); the µ-prox term stabilizes the shortened local optimization.
"""
from __future__ import annotations

from repro_torch.fl.strategy import LocalConfig, TorchStrategy


class TorchFedprox(TorchStrategy):
    name = "fedprox"
    supports_scan = True

    def __init__(self, *args, mu: float = 0.01, epoch_fraction: float = 0.4, **kwargs):
        super().__init__(*args, **kwargs)
        self.mu = mu
        self.epoch_fraction = epoch_fraction

    def client_config(self, t: int, cid: int, global_params) -> LocalConfig:
        epochs = max(1, int(round(self.epochs * self.epoch_fraction)))
        return LocalConfig(
            epochs=epochs,
            prox_mu=self.mu,
            compute_fraction=epochs / self.epochs,
        )


Fedprox = TorchFedprox
