"""Fedcom [16]: clients compress parameter updates before upload.

Block-local magnitude top-k sparsification of the whole cohort's flat
(P, D) update matrix in one ``topk_mask_rows`` launch (value+index
transport ⇒ upload fraction = 2 · keep_frac).  Download stays full-model
and computation is unchanged: the trade-off the paper attributes to message
compression.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.fl.strategy import LocalConfig, TorchStrategy
from repro_torch.kernels import ops as kops


class TorchFedcom(TorchStrategy):
    name = "fedcom"
    supports_scan = True     # the top-k mask runs inside the chunk

    def __init__(self, *args, keep_frac: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        if not 0.0 < keep_frac <= 1.0:
            raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")
        self.keep_frac = keep_frac

    def client_config(self, t: int, cid: int, global_params) -> LocalConfig:
        # values + indices => 2x the kept fraction in upload bytes
        return LocalConfig(
            epochs=self.epochs,
            upload_fraction=min(1.0, 2.0 * self.keep_frac),
        )

    def update_transform(self, template) -> Callable:
        keep_frac = self.keep_frac

        def apply(t: int, ids: np.ndarray, u: torch.Tensor) -> torch.Tensor:
            return kops.topk_mask_rows(u, keep_frac=keep_frac)

        return apply


Fedcom = TorchFedcom
