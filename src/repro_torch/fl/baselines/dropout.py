"""Federated Dropout [25]: clients train a random sub-model.

Each round each client receives a Bernoulli(keep_rate) mask over the weight
elements; masked entries are neither trained nor transmitted, so both
directions of communication scale with ``keep_rate``.  Computation is NOT
reduced (paper §4.5.3: width-wise dropout does not shorten the backward
graph), which the ledger reproduces with ``compute_fraction=1.0``.

Masks are a pure function of ``(seed, t, cid)``: an independent NumPy stream
per pair, drawn leaf by leaf in leaf order, bitwise the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fl.strategy import LocalConfig, TorchStrategy

_MASK_STREAM = 0x6D61736B  # 'mask': domain-separates from client_batch_rng


class TorchDropout(TorchStrategy):
    name = "dropout"
    supports_scan = True     # masks are built on the host per chunk
    # the Bernoulli sub-model mask is defined over the full weight tensors;
    # over LoRA factors it would zero adapter coordinates instead
    supports_param_subset = False
    param_subset_reason = "sub-model masks presume the full weight tensors"

    def __init__(self, *args, keep_rate: float = 0.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.keep_rate = keep_rate

    def local_mask(self, t: int, cid: int, template):
        """The (t, cid) sub-model mask over ``template`` (a parameter dict),
        on its device and in its dtype."""
        entropy = [int(self.seed) & 0xFFFFFFFFFFFFFFFF, int(t), int(cid), _MASK_STREAM]
        rng = np.random.default_rng(np.random.SeedSequence(entropy))
        out = {}
        for name, leaf in template.items():
            if leaf.dim() < 2:  # keep biases/norms intact (they're cheap)
                out[name] = torch.ones_like(leaf)
            else:
                m = rng.random(tuple(leaf.shape)) < self.keep_rate
                out[name] = torch.from_numpy(m).to(device=leaf.device, dtype=leaf.dtype)
        return out

    def client_config(self, t: int, cid: int, global_params) -> LocalConfig:
        mask = None if global_params is None else self.local_mask(t, cid, global_params)
        return LocalConfig(
            epochs=self.epochs,
            mask=mask,
            compute_fraction=1.0,               # paper §4.5.3
            download_fraction=self.keep_rate,
            upload_fraction=self.keep_rate,
        )


Dropout = TorchDropout
