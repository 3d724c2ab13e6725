"""QuantizedFL: 8-bit stochastic uniform quantization of updates (paper
refs [19] Dettmers / [20] QSGD — the other message-compression family the
paper groups with Fedcom).

Per-leaf symmetric quantization of each client's row of the flat (P, D)
update matrix: q = round(u / scale) with scale = max|u| / 127, rounded
stochastically; upload = int8 payload + one fp32 scale per leaf (upload
fraction bits / 32).  Leaf offsets are fixed from the parameter template.
A degenerate leaf — all-zero (scale 0) or holding inf/nan (scale not
finite) — becomes exactly 0; a zero-size leaf is passed through; columns
beyond the template's D are kept.

The rounding uniforms are the reference's ``jax.random.uniform`` draws
keyed by ``fold_in(fold_in(fold_in(PRNGKey(seed), t), cid), leaf)``, bitwise
(``repro_torch.random``).  They are drawn on the host and copied to the
device: about P · D draws per round.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.fl.strategy import LocalConfig, TorchStrategy


class TorchQuantizedFL(TorchStrategy):
    name = "quantized8"
    supports_scan = True     # as the reference declares; see scan_program

    def __init__(self, *args, bits: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.bits = bits

    def client_config(self, t: int, cid: int, global_params) -> LocalConfig:
        # int8 payload + one fp32 scale per leaf (scales are O(leaves) ≪ D)
        return LocalConfig(epochs=self.epochs, upload_fraction=self.bits / 32.0)

    def rounding_uniforms(self, t: int, ids: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """(P, D) float32: row k, leaf i's columns from the (t, ids[k], i) key."""
        key_t = prng.fold_in(prng.PRNGKey(self.seed), t)
        out = np.empty((len(ids), int(offsets[-1])), np.float32)
        for row, cid in enumerate(ids):
            key_c = prng.fold_in(key_t, int(cid))
            for i, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
                if hi > lo:
                    out[row, lo:hi] = prng.uniform(prng.fold_in(key_c, i), (int(hi - lo),))
        return out

    def scan_program(self):
        raise NotImplementedError(
            "QuantizedFL under driver='scan' needs its rounding uniforms drawn inside the "
            "chunk, by a device Threefry bitwise the host's (ROADMAP A.6); they are a host "
            "draw today. Run it with driver='loop'."
        )

    def update_transform(self, template) -> Callable:
        levels = 2 ** (self.bits - 1) - 1
        sizes = [int(leaf.numel()) for leaf in template.values()]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        d = int(offsets[-1])

        def apply(t: int, ids: np.ndarray, u: torch.Tensor) -> torch.Tensor:
            unif = torch.from_numpy(self.rounding_uniforms(t, ids, offsets)).to(u.device)
            segs = []
            for lo, hi in zip(offsets[:-1], offsets[1:]):
                seg = u[:, lo:hi]
                if hi == lo:   # zero-size leaf: nothing to quantize
                    segs.append(seg)
                    continue
                scale = torch.amax(torch.abs(seg), dim=1, keepdim=True) / levels
                ok = torch.isfinite(scale) & (scale > 0.0)
                safe = torch.where(ok, scale, torch.ones_like(scale))
                scaled = seg / safe
                floor = torch.floor(scaled)
                frac = scaled - floor
                q = floor + (unif[:, lo:hi] < frac).to(seg.dtype)
                q = torch.clamp(q, -levels - 1, levels)
                segs.append(torch.where(ok, q * safe, torch.zeros_like(seg)))
            out = torch.cat(segs, dim=1).to(u.dtype)
            if u.shape[1] > d:   # columns beyond the template's D are kept
                out = torch.cat([out, u[:, d:]], dim=1)
            return out

        return apply


QuantizedFL = TorchQuantizedFL
