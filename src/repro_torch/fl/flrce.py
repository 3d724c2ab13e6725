"""FLrce as a Strategy: relationship-based selection + early stopping.

Wraps :class:`repro_torch.core.FLrceServer` behind the engine-facing
Strategy interface (paper Alg. 4).  The server's state is allocated on the
run's device when ``run_federated`` binds it.  ``use_early_stopping=False``
is the paper's "FLrce w/o ES" ablation arm (named ``flrce_no_es``): Alg. 3
still runs on every exploit round, but its decision never ends the job.
``va_rows=K < M`` sketches the server's (M, D) V/A maps down to K rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.server import FLrceServer, check_va_rows
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
        use_early_stopping: bool = True,
        seed: int = 0,
        va_rows: Optional[int] = None,
        candidates_per_chunk: Optional[int] = None,
    ):
        super().__init__(num_clients, clients_per_round, local_epochs, seed)
        if candidates_per_chunk is not None:
            raise ValueError(
                "candidates_per_chunk narrows the compiled driver's device-side "
                "selection; the port has no compiled driver yet (ROADMAP A.6)"
            )
        check_va_rows(va_rows, clients_per_round)
        self.dim = dim
        self.es_threshold = es_threshold
        self.explore_decay = explore_decay
        self.use_es = use_early_stopping
        self.va_rows = va_rows
        self.server: Optional[FLrceServer] = None
        if not use_early_stopping:
            self.name = "flrce_no_es"

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
            va_rows=self.va_rows,
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
        return bool(stop) and self.use_es


FLrce = TorchFLrce
