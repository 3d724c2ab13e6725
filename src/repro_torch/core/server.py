"""FLrce server (paper Algorithm 4) on flattened updates.

State carried across rounds (Table 1), on the server's device:

* ``omega`` (M, M) — relationship map Ω
* ``heuristic`` (M,) — H, row-sums of Ω (Eq. 7)
* ``updates`` (M, D) — V, each client's latest update
* ``anchors`` (M, D) — the global model at each client's last active round
* ``last_round`` (M,) int32 — R, each client's last active round (-1 = never)

The maps are updated in place: they are the server's own O(M·D) buffers and
nothing else holds them, so a functional copy per round would only double
their memory.

**Sketched V/A** (``va_rows=K < M``): V and A keep K rows, allocated least
recently used (``va_owner`` (K,) maps a row to its client, ``va_slot`` (M,)
a client to its row, -1 = none).  A client whose row was evicted counts as
never seen, so its Ω entries keep their last values.  With ``va_rows=None``
or ``va_rows >= M`` the maps are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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
    va_owner: Optional[torch.Tensor] = None   # (K,) int32 sketch row → client; -1 empty
    va_slot: Optional[torch.Tensor] = None    # (M,) int32 client → sketch row; -1 none


def init_state(
    num_clients: int, dim: int, device: torch.device, va_rows: Optional[int] = None
) -> FLrceState:
    m = num_clients
    k = m if va_rows is None else min(int(va_rows), m)
    sketched = k < m

    def index_map(n: int) -> Optional[torch.Tensor]:
        return torch.full((n,), -1, dtype=torch.int32, device=device) if sketched else None

    return FLrceState(
        t=0,
        omega=torch.zeros((m, m), dtype=torch.float32, device=device),
        heuristic=torch.zeros((m,), dtype=torch.float32, device=device),
        updates=torch.zeros((k, dim), dtype=torch.float32, device=device),
        anchors=torch.zeros((k, dim), dtype=torch.float32, device=device),
        last_round=torch.full((m,), -1, dtype=torch.int32, device=device),
        va_owner=index_map(k),
        va_slot=index_map(m),
    )


def check_va_rows(va_rows: Optional[int], clients_per_round: int) -> None:
    if va_rows is not None and va_rows < clients_per_round:
        raise ValueError(
            f"va_rows={va_rows} must be >= clients_per_round={clients_per_round}: "
            "every selected client needs a sketch row"
        )


def sketch_assign_rows(
    va_owner: torch.Tensor,     # (K,) int32 sketch row → client id; -1 empty
    va_slot: torch.Tensor,      # (M,) int32 client id → sketch row; -1 none
    last_round: torch.Tensor,   # (M,) int32, the LRU key before this round's write
    ids: torch.Tensor,          # (P,) distinct selected client ids
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A sketch row for every selected client: ``(va_owner', va_slot', slots)``.

    A client that owns a row keeps it; the others take rows in eviction
    order: empty rows first, then the least recently active owners, ties by
    row index (a stable sort).  Rows owned by this cohort are never evicted,
    which K >= P makes always possible.  ``slots[i]`` is the row of
    ``ids[i]``.  The inputs are left as they are.
    """
    k = va_owner.shape[0]
    ids = ids.long()
    existing = va_slot[ids]                                   # (P,) row or -1
    has = existing >= 0
    # -1 would address the last row: the scatters below go through an
    # explicit out-of-range row that is cut off afterwards
    # (values are device tensors: a Python scalar would be a host copy)
    pinned = torch.zeros((k + 1,), dtype=torch.bool, device=va_owner.device)
    pinned[torch.where(has, existing, k).long()] = torch.ones_like(has)
    owner_last = torch.where(va_owner >= 0, last_round[va_owner.clamp_min(0).long()], -2)
    evict_key = torch.where(pinned[:k], torch.iinfo(torch.int32).max, owner_last)
    order = torch.argsort(evict_key, stable=True)             # empties, then LRU
    need = ~has
    rank = torch.cumsum(need.to(torch.int32), 0) - 1          # position among the needy
    slots = torch.where(has, existing, order[rank.clamp_min(0)].to(torch.int32))
    # clear the evicted owners' back-pointers before writing the new ones
    old_owner = va_owner[slots.long()]
    stale = need & (old_owner >= 0)
    m = va_slot.shape[0]
    new_slot = torch.cat([va_slot, va_slot.new_full((1,), -1)])
    new_slot[torch.where(stale, old_owner, m).long()] = torch.full_like(old_owner, -1)
    new_slot = new_slot[:m].clone()
    new_slot[ids] = slots
    new_owner = va_owner.clone()
    new_owner[slots.long()] = ids.to(torch.int32)
    return new_owner, new_slot, slots


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
        va_rows: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        check_va_rows(va_rows, clients_per_round)
        self.m = num_clients
        self.dim = dim
        self.p = clients_per_round
        self.psi = es_threshold
        self.decay = explore_decay
        self.device = resolve_device(device)
        self._rng = random.PRNGKey(seed)
        self.va_rows = None if va_rows is None else int(va_rows)
        self.state = init_state(num_clients, dim, self.device, self.va_rows)
        self._last_exploit = False

    @property
    def sketched(self) -> bool:
        return self.state.va_owner is not None

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
        if self.sketched:
            st.va_owner, st.va_slot, slots = sketch_assign_rows(
                st.va_owner, st.va_slot, st.last_round, ids
            )
            st.updates[slots.long()] = u32
            st.anchors[slots.long()] = w32
            st.last_round[ids] = st.t
            # an evicted client counts as never seen
            eff_last = torch.where(st.va_slot >= 0, st.last_round, -1)
            rows = relationship.sketched_relationship_block(
                ids, u32, w32, st.updates, st.anchors, st.va_owner, eff_last, st.t,
                st.omega[ids],
            )
        else:
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

    # -- the compiled driver's round pieces -----------------------------------
    # The carry is the server's own tensors: a chunk writes their rows in
    # place, every write masked by ``live`` (False once the job has stopped,
    # so a round after the stop leaves the state bitwise as it was).  The
    # key chain stays on the host: Alg. 2's draws depend on nothing else.

    def scan_carry(self) -> Dict[str, torch.Tensor]:
        """The state a chunk reads and writes, as device tensors (the
        state's own V/A maps, Ω, H and R, plus Alg. 3's scalars)."""
        st = self.state
        dev = self.device
        carry = {
            "omega": st.omega,
            "heuristic": st.heuristic.clone(),
            "updates": st.updates,
            "anchors": st.anchors,
            "last_round": st.last_round,
            "es_stopped": torch.tensor(st.stopped, device=dev),
            "es_stop_round": torch.tensor(-1 if st.stop_round is None else st.stop_round,
                                          dtype=torch.int32, device=dev),
            "pairs": torch.tensor(round(st.last_conflicts * self.p), dtype=torch.float32,
                                  device=dev),
        }
        if self.sketched:
            carry["va_owner"] = st.va_owner.clone()
            carry["va_slot"] = st.va_slot.clone()
        # rounds from st.t on draw from this key chain: key before round t
        self._scan_keys = {st.t: self._rng}
        return carry

    def explore_draws(self, ts: Sequence[int], n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Alg. 2's host draws for rounds ``ts`` over ``n`` candidates:
        ``(explore (R,) bool, explore slots (R, P) int64)``, each round's
        key split off the chain exactly as :meth:`select` splits it."""
        explore = np.zeros(len(ts), bool)
        slots = np.zeros((len(ts), self.p), np.int64)
        for i, t in enumerate(ts):
            key, sub = random.split(self._scan_keys[int(t)])
            self._scan_keys[int(t) + 1] = key
            explore[i], slots[i] = selection.explore_draws(sub, int(t), n, self.p, self.decay)
        return explore, slots

    def scan_select(self, carry, explore, explore_slots, cand) -> Tuple[torch.Tensor, torch.Tensor]:
        """Alg. 2 on the device over candidates ``cand``: ``(slots, exploited)``;
        ``cand[slots]`` are the client ids."""
        return selection.select_clients_device_candidates(explore, explore_slots,
                                                          carry["heuristic"], cand, self.p)

    def scan_ingest(self, carry, w_t, ids, client_updates, t, live) -> None:
        """:meth:`ingest` on the carry at device round ``t``, rows masked by ``live``."""
        ids = ids.long()
        w32 = w_t.float()
        u32 = client_updates.float()
        keep = lambda new, old: torch.where(live, new, old)  # noqa: E731
        upd, anc, last, omega = (carry[k] for k in ("updates", "anchors", "last_round", "omega"))
        t32 = t.to(torch.int32)
        if self.sketched:
            owner, slot, rows_k = sketch_assign_rows(carry["va_owner"], carry["va_slot"], last, ids)
            carry["va_owner"].copy_(keep(owner, carry["va_owner"]))
            carry["va_slot"].copy_(keep(slot, carry["va_slot"]))
            rows_k = rows_k.long()
            upd[rows_k] = keep(u32, upd[rows_k])
            anc[rows_k] = keep(w32.expand_as(u32), anc[rows_k])
            last[ids] = keep(t32, last[ids])
            eff_last = torch.where(carry["va_slot"] >= 0, last, -1)
            rows = relationship.sketched_relationship_block(
                ids, u32, w32, upd, anc, carry["va_owner"], eff_last, t, omega[ids])
        else:
            upd[ids] = keep(u32, upd[ids])
            anc[ids] = keep(w32.expand_as(u32), anc[ids])
            last[ids] = keep(t32, last[ids])
            rows = relationship.relationship_block(ids, u32, w32, upd, anc, last, t, omega[ids])
        omega[ids] = keep(rows, omega[ids])
        h = carry["heuristic"]
        h.copy_(keep(heuristics.update_heuristic_rows(h, omega, ids), h))

    def scan_check_early_stop(self, carry, selected_updates, t, exploited, live) -> torch.Tensor:
        """Alg. 3 on the device: the exact pair count against the host's
        integer threshold (:func:`early_stopping.stop_count`), so the
        decision is :meth:`check_early_stop`'s.  The Gram runs every round;
        explore rounds never stop.  Returns this round's decision."""
        pairs = early_stopping.conflict_pairs(selected_updates)
        return self._scan_stop(carry, pairs, t, exploited, live)

    def _scan_stop(self, carry, pairs, t, exploited, live) -> torch.Tensor:
        """Alg. 3's decision from the ordered-pair count, written to the carry."""
        stop = torch.logical_and(exploited,
                                 pairs >= float(early_stopping.stop_count(self.psi, self.p)))
        prev = carry["es_stopped"]
        first = torch.logical_and(live, torch.logical_not(prev))
        carry["es_stop_round"].copy_(torch.where(
            first, torch.where(stop, t.to(torch.int32), -1), carry["es_stop_round"]))
        carry["es_stopped"].copy_(torch.logical_or(prev, torch.logical_and(live, stop)))
        carry["pairs"].copy_(torch.where(live, torch.where(exploited, pairs, 0.0), carry["pairs"]))
        return stop

    # -- the async round's pieces (out-of-order arrival) ---------------------
    # The async driver keeps departed updates in a fixed-shape buffer of
    # K = (S+1)·P rows and lands a subset each round.  With every row landing
    # in the round it left (max_staleness=0) both pieces are bitwise
    # scan_ingest and scan_check_early_stop.

    def scan_ingest_async(self, carry, w_t, ids, t_depart, client_updates, anchor_rows,
                          arrived, live) -> None:
        """:meth:`scan_ingest` over the arrival buffer: ``ids``, ``t_depart``
        (K,), ``client_updates`` and ``anchor_rows`` (K, D, the global model
        at each row's departure), ``arrived`` (K,) the rows landing now.

        V/A/R rows take the update with its departure anchor and round, so
        Eq. 5/6 judge freshness against the round the update left.  When a
        client lands twice in one round the freshest departure wins.  Losers,
        rows that did not arrive and every row once the job has stopped
        write nothing: their scatter goes to the first winner's row with the
        winner's values (a duplicate index with equal values, so the result
        is the winner's whatever the order), or, with no winner, rewrites
        row ``ids[0]`` of each map with its own contents.  Shapes stay fixed
        and nothing is read back to the host."""
        if self.sketched:
            raise ValueError("async ingest needs exact V/A maps (va_rows=None): the sketch's "
                             "LRU row assignment is departure-ordered")
        ids = ids.long()
        w32 = w_t.float()
        u32 = client_updates.float()
        a32 = anchor_rows.float()
        dep = t_depart.to(torch.int32)
        upd, anc, last, omega = (carry[k] for k in ("updates", "anchors", "last_round", "omega"))
        # freshest departure wins: row i loses if an arrived row j holds the
        # same client with a later departure
        newer = (ids[:, None] == ids[None, :]) & arrived[None, :] & (dep[None, :] > dep[:, None])
        win = arrived & ~newer.any(dim=1) & live
        any_win = win.any()
        k = ids.shape[0]
        rows_k = torch.arange(k, device=ids.device)
        src = torch.where(win, rows_k, torch.argmax(win.to(torch.int32)))   # first winner
        tgt = ids[src]

        def scatter(dst, values):
            dst[tgt] = torch.where(any_win, values[src], dst[tgt])

        scatter(upd, u32)
        scatter(anc, a32)
        scatter(last, dep)
        rows = relationship.relationship_block(ids, u32, w32, upd, anc, last, dep, omega[ids])
        scatter(omega, rows)
        h = carry["heuristic"]
        h.copy_(torch.where(any_win, heuristics.update_heuristic_rows(h, omega, tgt), h))

    def scan_check_early_stop_async(self, carry, arrived_updates, arrived, t, exploited,
                                    live) -> torch.Tensor:
        """Alg. 3 over this round's arrivals: a pair counts only if both of
        its rows landed, the count is still judged against the cohort size
        P's host threshold, and ``exploited`` is the landing round's phase."""
        pairs = early_stopping.masked_conflict_pairs(arrived_updates, arrived)
        return self._scan_stop(carry, pairs, t, exploited, live)

    def load_scan_carry(self, carry, t_next: int, last_exploit: bool) -> None:
        """Write a settled carry back into the state (no chunk in flight)."""
        st = self.state
        stop_round = int(carry["es_stop_round"])
        st.t = int(t_next)
        st.omega, st.updates, st.anchors = carry["omega"], carry["updates"], carry["anchors"]
        st.last_round = carry["last_round"]
        st.heuristic = carry["heuristic"].clone()
        st.stopped = bool(carry["es_stopped"])
        st.stop_round = None if stop_round < 0 else stop_round
        st.last_conflicts = int(carry["pairs"]) / self.p
        if self.sketched:
            st.va_owner, st.va_slot = carry["va_owner"].clone(), carry["va_slot"].clone()
        self._rng = self._scan_keys[int(t_next)]
        self._last_exploit = bool(last_exploit)
