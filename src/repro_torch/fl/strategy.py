"""Strategy interface: what varies between FLrce and the baselines.

A strategy controls client selection, the per-client local-training config,
an update transform on the device (compression), per-round bookkeeping with
the stop decision, and the ledger's cost fractions.  For the compiled round
driver (``driver="scan"``) a strategy also hands out its device pieces as a
:class:`ScanProgram`.  The reference's mesh hooks have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class LocalConfig:
    epochs: int
    prox_mu: float = 0.0
    mask: Optional[Any] = None           # dropout sub-model mask
    freeze_frac: float = 0.0             # timelyfl layer freezing
    compute_fraction: float = 1.0        # relative FLOPs vs full local training
    download_fraction: float = 1.0       # fraction of model bytes sent down
    upload_fraction: float = 1.0         # fraction of update bytes sent up


@dataclasses.dataclass
class ScanProgram:
    """A strategy's round pieces for the compiled driver (``fl/scan_driver.py``).

    Every device function runs inside a chunk, which on the card is a
    captured CUDA graph: no host sync, no data-dependent Python branch, and
    every write to the carry masked by ``live`` (a () bool, False once the
    job has stopped), so a round after the stop leaves the carry bitwise.

    * ``carry`` — the device state the chunk reads and writes in place
      (``{}`` for a stateless strategy).
    * ``draws(ts, n) -> (explore (R,) bool, explore_slots (R, P) int)`` —
      host draws for device selection over ``n`` candidates, made per chunk
      (they may depend only on the seed and the round).
    * ``select(carry, explore, explore_slots, cand) -> (slots, exploited)``
      — device selection of one round over the candidate ids ``cand``
      (P_cand,); ``cand[slots]`` are the client ids.  ``None``: the driver
      selects on the host with :meth:`TorchStrategy.select`.
    * ``post_round(carry, t, w_before, ids, update_matrix, exploited, live)
      -> stop`` — per-round bookkeeping and the stop decision (a () bool).
      Only with ``select``: a host-selected chunk cannot react to a stop.
    * ``finalize(carry, t_next, last_exploit)`` — writes a settled carry back
      into the strategy (no chunk in flight), so the host sees the state the
      loop driver would have left.
    """

    carry: Dict[str, torch.Tensor]
    draws: Optional[Callable] = None
    select: Optional[Callable] = None
    post_round: Optional[Callable] = None
    finalize: Optional[Callable] = None


# The port's classes carry names of their own and are exported under the
# reference's names below: the reference's strategy-conformance lint scans
# the whole source tree, keys classes by bare name and treats subclasses of a
# class named ``Strategy`` as reference strategies.  The port's classes make
# none of the reference's compiled-driver promises, so they stay out of it.
class TorchStrategy:
    """Base = FedAvg: uniform random selection, full local training."""

    name = "fedavg"

    def __init__(self, num_clients: int, clients_per_round: int, local_epochs: int, seed: int = 0):
        self.m = num_clients
        self.p = clients_per_round
        self.epochs = local_epochs
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def bind_device(self, device: torch.device) -> None:
        """Called once by ``run_federated`` before the first round, with the
        device the round's tensors live on.  Default: no device state."""

    def select(self, t: int) -> np.ndarray:
        return np.sort(self.rng.choice(self.m, size=self.p, replace=False))

    def client_config(self, t: int, cid: int, global_params) -> LocalConfig:
        """Per-(round, client) local-training metadata + ledger fractions."""
        return LocalConfig(epochs=self.epochs)

    def update_transform(self, template) -> Optional[Callable]:
        """The strategy's update post-processing stage, run on the device.

        ``None`` (identity) or ``apply(t, ids, u) -> u'``: ``t`` is the round
        index, ``ids`` the selected client ids (host ints) and ``u`` the flat
        (P, D) fp32 update matrix in leaf order on the run's device; the
        result has u's shape and device.  ``apply`` must be deterministic
        given ``(t, ids, u)``: randomness comes from keys folded from the
        strategy seed and ``(t, cid)``, never from host RNG state.
        ``template`` is the global parameter dict; static leaf sizes and
        offsets are read from it here, once per job.  Upload byte fractions
        are reported through :meth:`client_config`.
        """
        return None

    @property
    def transforms_updates(self) -> bool:
        """True when :meth:`update_transform` is overridden (derived, so a new
        compression strategy cannot skip its own stage)."""
        return type(self).update_transform is not TorchStrategy.update_transform

    # -- the compiled driver (driver="scan") ---------------------------------
    supports_scan: bool = False
    """True: ``driver="scan"`` runs this strategy's rounds in chunks.  Its
    ``client_config`` is pure (with ``global_params=None`` it returns the
    mask-free form), its ``update_transform`` runs inside a chunk, masks and
    freeze flags come only with host selection, and selection is either
    :meth:`select` (independent of round results) or a device ``select`` of
    its :meth:`scan_program`.  False: the driver falls back to the loop."""

    supports_paged_store: bool = True
    """True: the driver may page this strategy's chunks from a host store
    (``client_store="paged"``): device selection honours the candidate set."""

    supports_param_subset: bool = True
    """True: sound when the trained dict is a parameter subset of the
    deployed model (``model.param_subset``, e.g. ``LoRAClassifier``'s
    adapters): selection, Eq. 4, FLrce's maps and Alg. 3 are defined on
    whatever flat vector the trained dict gives.  False: the strategy's
    per-client variants presume the full parameter vector (Dropout's masks,
    TimelyFL's depth-indexed freezing); ``run_federated`` rejects such a
    model, and ``param_subset_reason`` says why."""

    param_subset_reason: Optional[str] = None

    def propose_candidates(self, ts) -> Optional[np.ndarray]:
        """Sorted unique global ids (P_cand >= P) that device selection may
        pick from in the chunk of rounds ``ts``; ``None`` for all clients."""
        return None

    def scan_program(self) -> ScanProgram:
        """Host selection, no bookkeeping, never stops (FedAvg's program)."""
        if not self.supports_scan:
            raise NotImplementedError(f"{self.name} does not support driver='scan'")
        return ScanProgram(carry={})

    def post_round(
        self,
        t: int,
        w_before: torch.Tensor,       # (D,) flat global model sent this round
        client_ids: np.ndarray,
        update_matrix: torch.Tensor,  # (P, D) flat client updates, after
        #                               the update transform
        stats: list,
    ) -> bool:
        """Per-round bookkeeping with the round's flat device buffers; returns
        the stop decision."""
        return False

    @property
    def last_round_was_exploit(self) -> bool:
        return False


Strategy = TorchStrategy
