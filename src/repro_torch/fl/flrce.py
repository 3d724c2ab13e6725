"""FLrce as a Strategy: relationship-based selection + early stopping.

Wraps :class:`repro_torch.core.FLrceServer` behind the engine-facing
Strategy interface (paper Alg. 4).  The server's state is allocated on the
run's device when ``run_federated`` binds it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.server import FLrceServer
from repro_torch.fl.strategy import TorchStrategy


# named apart from the reference's FLrce for its lint; see fl/strategy.py
class TorchFLrce(TorchStrategy):
    name = "flrce"

    def __init__(
        self,
        num_clients: int,
        clients_per_round: int,
        local_epochs: int,
        dim: int,
        es_threshold: float = 5.0,
        explore_decay: float = 0.98,
        seed: int = 0,
    ):
        super().__init__(num_clients, clients_per_round, local_epochs, seed)
        self.dim = dim
        self.es_threshold = es_threshold
        self.explore_decay = explore_decay
        self.server: Optional[FLrceServer] = None

    def bind_device(self, device: torch.device) -> None:
        if self.server is not None:
            raise ValueError("this FLrce strategy already ran a job; make a new one")
        self.server = FLrceServer(
            num_clients=self.m,
            dim=self.dim,
            clients_per_round=self.p,
            es_threshold=self.es_threshold,
            explore_decay=self.explore_decay,
            seed=self.seed,
            device=device,
        )

    def _bound(self) -> FLrceServer:
        if self.server is None:
            raise RuntimeError("FLrce has no device yet: run it through run_federated")
        return self.server

    def select(self, t: int) -> np.ndarray:
        return self._bound().select()

    @property
    def last_round_was_exploit(self) -> bool:
        return self.server is not None and self.server.last_round_was_exploit

    def post_round(self, t, w_before, client_ids, update_matrix, stats) -> bool:
        server = self._bound()
        updates = update_matrix.float()
        server.ingest(w_before.float(), client_ids, updates)
        stop = server.check_early_stop(updates)
        server.advance_round()
        return bool(stop)


FLrce = TorchFLrce
