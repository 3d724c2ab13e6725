"""FLrce as a Strategy: relationship-based selection + early stopping.

Wraps :class:`repro_torch.core.FLrceServer` behind the engine-facing
Strategy interface (paper Alg. 4).  The server's state is allocated on the
run's device when ``run_federated`` binds it.  ``use_early_stopping=False``
is the paper's "FLrce w/o ES" ablation arm (named ``flrce_no_es``): Alg. 3
still runs on every exploit round, but its decision never ends the job.
``va_rows=K < M`` sketches the server's (M, D) V/A maps down to K rows.
Under ``driver="scan"`` selection, ingest and Alg. 3 run inside the chunk on
the server's own tensors (:meth:`TorchFLrce.scan_program`), and
``candidates_per_chunk=P_cand < M`` narrows each chunk's device selection to
a host-proposed candidate set (:meth:`TorchFLrce.propose_candidates`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.server import FLrceServer, check_va_rows
from repro_torch.fl.strategy import ScanProgram, TorchStrategy


# named apart from the reference's FLrce for its lint; see fl/strategy.py
class TorchFLrce(TorchStrategy):
    name = "flrce"
    supports_scan = True

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
            if candidates_per_chunk < clients_per_round:
                raise ValueError(
                    f"candidates_per_chunk={candidates_per_chunk} must be >= "
                    f"clients_per_round={clients_per_round}"
                )
            candidates_per_chunk = min(int(candidates_per_chunk), num_clients)
        self.candidates_per_chunk = candidates_per_chunk
        self._heur_snapshot: Optional[np.ndarray] = None
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


    def propose_candidates(self, ts) -> Optional[np.ndarray]:
        """The chunk's candidate set under ``candidates_per_chunk=P_cand``:
        the top P_cand/2 clients by the host's snapshot of H, then a seeded
        random fill, sorted.  The snapshot is taken only when no chunk is in
        flight (job start and every ``finalize``), so under pipelining it is
        stale: that, and selecting within the proposal, is the
        approximation.  ``None`` (all clients) without ``candidates_per_chunk``."""
        p_cand = self.candidates_per_chunk
        if p_cand is None or p_cand >= self.m:
            return None
        heur = self._heur_snapshot
        if heur is None:
            heur = np.zeros(self.m, np.float32)
        n_top = p_cand // 2
        top = np.lexsort((np.arange(self.m), -heur))[:n_top]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0x5EED, int(ts[0])]))
        rest = np.setdiff1d(np.arange(self.m), top, assume_unique=False)
        fill = rng.choice(rest, size=p_cand - len(top), replace=False)
        return np.sort(np.concatenate([top, fill])).astype(np.int64)

    def scan_program(self) -> ScanProgram:
        """Alg. 2 (device top-P over host draws), Alg. 1 ingest and Alg. 3 on
        the server's own tensors; ``finalize`` writes the carry back."""
        server = self._bound()
        use_es = bool(self.use_es)
        carry = server.scan_carry()
        self._heur_snapshot = server.state.heuristic.cpu().numpy()

        def post_round(carry, t, w_before, ids, update_matrix, exploited, live):
            u32 = update_matrix.float()
            server.scan_ingest(carry, w_before, ids, u32, t, live)
            stop = server.scan_check_early_stop(carry, u32, t, exploited, live)
            return stop if use_es else torch.zeros_like(stop)

        def finalize(carry, t_next, last_exploit):
            server.load_scan_carry(carry, t_next, last_exploit)
            self._heur_snapshot = server.state.heuristic.cpu().numpy()

        return ScanProgram(carry=carry, draws=server.explore_draws, select=server.scan_select,
                           post_round=post_round, finalize=finalize)


FLrce = TorchFLrce
