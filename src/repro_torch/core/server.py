"""FLrce server (paper Algorithm 4) on flattened updates, exact V/A maps.

State carried across rounds (Table 1), on the server's device:

* ``omega`` (M, M) — relationship map Ω
* ``heuristic`` (M,) — H, row-sums of Ω (Eq. 7)
* ``updates`` (M, D) — V, each client's latest update
* ``anchors`` (M, D) — the global model at each client's last active round
* ``last_round`` (M,) int32 — R, each client's last active round (-1 = never)

The maps are updated in place: they are the server's own O(M·D) buffers and
nothing else holds them, so a functional copy per round would only double
their memory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import early_stopping, heuristics, relationship, selection
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class FLrceState:
    t: int
    omega: torch.Tensor         # (M, M)
    heuristic: torch.Tensor     # (M,)
    updates: torch.Tensor       # (M, D)
    anchors: torch.Tensor       # (M, D)
    last_round: torch.Tensor    # (M,) int32
    stopped: bool = False
    stop_round: Optional[int] = None
    last_conflicts: float = 0.0


def init_state(num_clients: int, dim: int, device: torch.device) -> FLrceState:
    m = num_clients
    return FLrceState(
        t=0,
        omega=torch.zeros((m, m), dtype=torch.float32, device=device),
        heuristic=torch.zeros((m,), dtype=torch.float32, device=device),
        updates=torch.zeros((m, dim), dtype=torch.float32, device=device),
        anchors=torch.zeros((m, dim), dtype=torch.float32, device=device),
        last_round=torch.full((m,), -1, dtype=torch.int32, device=device),
    )


class FLrceServer:
    """Relationship-based selection + early stopping, over flattened updates."""

    def __init__(
        self,
        num_clients: int,
        dim: int,
        clients_per_round: int,
        es_threshold: float,
        explore_decay: float = 0.98,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        self.m = num_clients
        self.dim = dim
        self.p = clients_per_round
        self.psi = es_threshold
        self.decay = explore_decay
        self.device = resolve_device(device)
        self._rng = random.PRNGKey(seed)
        self.state = init_state(num_clients, dim, self.device)
        self._last_exploit = False

    # -- Alg. 4 line 5: client selection ------------------------------------
    def select(self) -> np.ndarray:
        self._rng, sub = random.split(self._rng)
        ids, exploited = selection.select_clients(
            sub, self.state.heuristic, self.state.t, self.p, self.decay
        )
        self._last_exploit = exploited
        return ids

    @property
    def last_round_was_exploit(self) -> bool:
        return self._last_exploit

    # -- Alg. 4 lines 9-19: ingest updates, refresh Ω and H ------------------
    def ingest(
        self,
        w_t: torch.Tensor,
        client_ids: Sequence[int],
        client_updates: torch.Tensor,   # (P, D)
    ) -> None:
        st = self.state
        ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.long, device=self.device)
        w32 = w_t.float()
        u32 = client_updates.float()
        # Alg. 4 writes V/A/R first (line 10), then models relationships, so
        # a pair selected in the same round is compared synchronously.
        st.updates[ids] = u32
        st.anchors[ids] = w32
        st.last_round[ids] = st.t
        rows = relationship.relationship_block(
            ids, u32, w32, st.updates, st.anchors, st.last_round, st.t, st.omega[ids]
        )
        st.omega[ids] = rows
        st.heuristic = heuristics.update_heuristic_rows(st.heuristic, st.omega, ids)

    # -- Alg. 4 lines 20-23: early stopping ---------------------------------
    def check_early_stop(self, selected_updates: torch.Tensor) -> bool:
        decision = early_stopping.should_stop(
            selected_updates, self.psi, is_exploit_round=self._last_exploit
        )
        st = self.state
        st.stop_round = st.stop_round if st.stopped else (st.t if decision.stop else None)
        st.stopped = st.stopped or decision.stop
        st.last_conflicts = decision.conflicts
        return decision.stop

    def advance_round(self) -> None:
        self.state.t += 1
