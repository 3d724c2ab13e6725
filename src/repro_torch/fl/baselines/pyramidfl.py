"""PyramidFL [23]: utility-ranked client selection + per-client epoch scaling.

Selection utility combines statistical utility (latest observed local loss —
higher loss = more to learn) and system utility (simulated per-client speed).
Selected clients get epochs scaled by their intra-round rank (the 'pyramid'),
saving computation on the lower-ranked participants.  All of it is host
NumPy, bitwise the reference's given the same observed losses.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fl.strategy import LocalConfig, TorchStrategy


class TorchPyramidFL(TorchStrategy):
    name = "pyramidfl"
    # selection and epochs follow the losses of earlier rounds, so a chunk
    # cannot be planned ahead: driver="scan" falls back to the loop
    supports_scan = False

    def __init__(self, *args, explore_frac: float = 0.2, min_epoch_frac: float = 0.4, **kwargs):
        super().__init__(*args, **kwargs)
        self.explore_frac = explore_frac
        self.min_epoch_frac = min_epoch_frac
        # simulated per-client system speed in (0.5, 1.5)
        self.speed = 0.5 + self.rng.random(self.m)
        self.last_loss = np.full(self.m, np.inf)  # unseen => maximal utility
        self._epoch_plan: dict = {}

    def select(self, t: int) -> np.ndarray:
        n_explore = max(1, int(self.explore_frac * self.p)) if t > 0 else self.p
        seen = np.isfinite(self.last_loss)
        utility = np.where(seen, self.last_loss, np.nanmax(self.last_loss[seen]) if seen.any() else 1.0)
        utility = utility * self.speed
        order = np.argsort(-utility)
        exploit_ids = [cid for cid in order if seen[cid]][: self.p - n_explore]
        pool = np.setdiff1d(np.arange(self.m), np.asarray(exploit_ids, dtype=int))
        explore_ids = self.rng.choice(pool, size=self.p - len(exploit_ids), replace=False)
        ids = np.sort(np.concatenate([np.asarray(exploit_ids, dtype=int), explore_ids]))
        # pyramid epoch plan: rank within the round by utility
        ranked = sorted(ids, key=lambda c: -utility[c])
        self._epoch_plan = {}
        for rank, cid in enumerate(ranked):
            frac = 1.0 - (1.0 - self.min_epoch_frac) * rank / max(1, self.p - 1)
            self._epoch_plan[int(cid)] = max(1, int(round(self.epochs * frac)))
        return ids

    def client_config(self, t: int, cid: int, global_params) -> LocalConfig:
        epochs = self._epoch_plan.get(int(cid), self.epochs)
        return LocalConfig(epochs=epochs, compute_fraction=epochs / self.epochs)

    def post_round(self, t, w_before, client_ids, update_matrix, stats) -> bool:
        for cid, st in zip(client_ids, stats):
            self.last_loss[int(cid)] = st.get("final_loss", np.inf)
        return False


PyramidFL = TorchPyramidFL
