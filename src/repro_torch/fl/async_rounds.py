"""Staleness-aware asynchronous rounds for the compiled round driver.

``run_federated(..., driver="scan", async_rounds=AsyncConfig(...))`` turns
the scan driver's synchronous rounds into staleness-aware ones:

* every selected client still trains at its **departure** round ``t`` on the
  round-``t`` model, but its update is held back ``τ ∈ [0, max_staleness]``
  rounds (a per-(round, client) delay from a seeded synthetic trace, or a
  per-client delay profile);
* the round-``t + τ`` aggregation applies the staleness-weighted Eq. 4 over
  what **arrived** that round: each update's weight ``n_k`` is scaled by
  ``decay(τ)`` and the scaled weights renormalized
  (:func:`repro_torch.fl.aggregation.staleness_weights` is the host-side
  reference);
* FLrce's ingest and Alg. 3 are redone for out-of-order arrival: V/A/R rows
  update against the round the update *left*
  (``FLrceServer.scan_ingest_async``).

With ``max_staleness=0`` every update lands in the round it left and
``decay(0) == 1.0`` leaves the Eq. 4 weights as they are, so the async run
is bitwise the synchronous scan run on the same device.

:func:`staleness_of` is the one place that does round-index arithmetic on
the pending-update buffers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def staleness_of(t_depart, t_land):
    """Staleness τ of an update that left at ``t_depart`` and lands at
    ``t_land`` (τ = t_land − t_depart, ≥ 0 for a delivered update); works
    on ints and tensors."""
    return t_land - t_depart


def default_decay(tau: int) -> float:
    """Polynomial staleness discount ``1 / (1 + τ)`` (decay(0) == 1.0)."""
    return 1.0 / (1.0 + tau)


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Configuration for ``run_federated(..., async_rounds=...)``.

    * ``max_staleness`` — the largest delivery delay τ (rounds).  ``0`` is
      the synchronous-equivalence mode.
    * ``decay`` — ``τ → weight`` applied to each arrived update's Eq. 4
      sample count before renormalization; ``decay(0)`` must be exactly 1.0
      and the decay finite and positive on ``[0, max_staleness]``.
      ``None``: :func:`default_decay`.
    * ``trace`` — ``None`` for the seeded synthetic trace
      (:func:`synthetic_delays`), or a length-M integer array of per-client
      delays, clipped to ``[0, max_staleness]``.
    """

    max_staleness: int = 0
    decay: Optional[Callable[[int], float]] = None
    trace: Optional[Any] = None

    def validate(self, num_clients: Optional[int] = None) -> None:
        if not isinstance(self.max_staleness, (int, np.integer)) \
                or isinstance(self.max_staleness, bool):
            raise ValueError(
                f"AsyncConfig.max_staleness must be an int, got {self.max_staleness!r}")
        if self.max_staleness < 0:
            raise ValueError(f"AsyncConfig.max_staleness must be >= 0, got {self.max_staleness}")
        self.decay_table()
        if self.trace is not None:
            tr = np.asarray(self.trace)
            if tr.ndim != 1:
                raise ValueError(
                    f"AsyncConfig.trace must be a 1-D per-client delay array, got shape {tr.shape}")
            if num_clients is not None and len(tr) != num_clients:
                raise ValueError(f"AsyncConfig.trace has {len(tr)} entries but the dataset has "
                                 f"{num_clients} clients")

    def decay_table(self) -> np.ndarray:
        """``decay`` at every reachable τ: the (S+1,) float32 table the round
        body gathers from."""
        fn = self.decay if self.decay is not None else default_decay
        table = np.asarray([float(fn(tau)) for tau in range(self.max_staleness + 1)], np.float32)
        if table[0] != 1.0:
            raise ValueError(
                "AsyncConfig.decay(0) must be exactly 1.0 so that max_staleness=0 reproduces "
                f"the synchronous driver bitwise; got {table[0]!r}")
        if not np.all(np.isfinite(table)) or np.any(table <= 0.0):
            raise ValueError(f"AsyncConfig.decay must be finite and > 0 on "
                             f"[0, {self.max_staleness}]; got table {table.tolist()}")
        return table


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2³²`` for int64 ``x`` in [0, 2³²): the constant in two
    16-bit halves, so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def synthetic_delays(seed: int, t, ids, max_staleness: int) -> torch.Tensor:
    """Delivery delay in ``[0, max_staleness]`` of each client ``ids`` departing
    at round ``t``: a uint32 integer hash of ``(seed, t, cid)``, the
    reference's bit for bit, as int32.

    The hash is computed in int64 with every product and sum masked to 32
    bits (CUDA has few uint32 operations), so ``t`` and ``ids`` may be
    device tensors inside a captured round: nothing is read back.
    """
    ids = torch.as_tensor(ids)
    t = torch.as_tensor(t, device=ids.device)
    x = _mul32(ids.long() & _MASK32, 0x9E3779B1)
    x = (x + _mul32(t.long() & _MASK32, 0x85EBCA77)) & _MASK32
    x = (x + (seed & _MASK32)) & _MASK32
    x = _mul32(x ^ (x >> 15), 0x2C1B3C6D)
    x = _mul32(x ^ (x >> 12), 0x297A2D39)
    x = x ^ (x >> 15)
    return (x % (max_staleness + 1)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class AsyncPlan:
    """The driver's resolved :class:`AsyncConfig`, its tables on the run's device.

    ``depth`` (= max_staleness + 1) sizes the ring of pending cohorts: slot
    ``t mod depth`` is free at round ``t``, since its previous occupant left
    ``depth`` rounds ago and landed at ``t - 1`` at the latest.
    """

    max_staleness: int
    decay_table: torch.Tensor           # (S+1,) float32
    trace: Optional[torch.Tensor]       # (M,) int64 per-client delays, or None
    seed: int

    @property
    def depth(self) -> int:
        return self.max_staleness + 1

    def delays(self, t, ids: torch.Tensor) -> torch.Tensor:
        """Delay τ (int32) of each update of the cohort ``ids`` departing at ``t``."""
        if self.trace is not None:
            return self.trace[ids.long()].clamp(0, self.max_staleness).to(torch.int32)
        return synthetic_delays(self.seed, t, ids, self.max_staleness)


def resolve_async_plan(cfg: AsyncConfig, *, num_clients: int, seed: int,
                       device) -> AsyncPlan:
    """Validate ``cfg`` and put its tables on ``device``."""
    cfg.validate(num_clients)
    trace = None
    if cfg.trace is not None:
        trace = torch.from_numpy(
            np.clip(np.asarray(cfg.trace, np.int64), 0, cfg.max_staleness)).to(device)
    return AsyncPlan(max_staleness=int(cfg.max_staleness),
                     decay_table=torch.from_numpy(cfg.decay_table()).to(device),
                     trace=trace, seed=int(seed))
