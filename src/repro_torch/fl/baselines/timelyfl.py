"""TimelyFL [43]: heterogeneity-aware partial training via layer freezing.

Each client has a simulated capability c_k ∈ (0.3, 1.0]; per round it freezes
the earliest (1 − c_k) fraction of parameter leaves so local training fits its
deadline.  Frozen layers produce no update and are not uploaded; backward
flops scale with the trainable fraction.
"""
from __future__ import annotations

from repro_torch.fl.strategy import LocalConfig, TorchStrategy


class TorchTimelyFL(TorchStrategy):
    name = "timelyfl"
    supports_scan = True     # freeze flags are built on the host per chunk
    # freezing orders the full model's leaves front to back; an adapter
    # dict's leaf order has no depth meaning
    supports_param_subset = False
    param_subset_reason = "layer freezing is depth-indexed over the full model"

    def __init__(self, *args, min_capability: float = 0.3, epoch_fraction: float = 0.6, **kwargs):
        super().__init__(*args, **kwargs)
        self.capability = min_capability + (1.0 - min_capability) * self.rng.random(self.m)
        self.epoch_fraction = epoch_fraction

    def client_config(self, t: int, cid: int, global_params) -> LocalConfig:
        cap = float(self.capability[cid])
        epochs = max(1, int(round(self.epochs * self.epoch_fraction)))
        freeze = 1.0 - cap
        return LocalConfig(
            epochs=epochs,
            freeze_frac=freeze,
            compute_fraction=cap * epochs / self.epochs,
            upload_fraction=cap,     # frozen leaves are not uploaded
            download_fraction=1.0,
        )


TimelyFL = TorchTimelyFL
