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
keyed by ``fold_in(fold_in(fold_in(PRNGKey(seed), t), cid), leaf)``, bitwise:
P · D draws a round.  On the card both drivers draw them with one launch of
the Threefry kernel (``kernels.ops.rounding_uniforms``), which reads the
round index and the client ids from device tensors, so the compiled round
driver (``driver="scan"``) captures the draw with the round and replays it
with no host read.  On the CPU the loop draws them on the host
(:meth:`rounding_uniforms`, ``repro_torch.random``) and a chunk's round body
with the kernel's plain version.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.fl.strategy import LocalConfig, TorchStrategy
from repro_torch.kernels import ops as kops


class TorchQuantizedFL(TorchStrategy):
    name = "quantized8"
    supports_scan = True     # the rounding uniforms are drawn inside the chunk

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

    def update_transform(self, template) -> Callable:
        levels = 2 ** (self.bits - 1) - 1
        sizes = [int(leaf.numel()) for leaf in template.values()]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        d = int(offsets[-1])
        device = next(iter(template.values())).device if template else torch.device("cpu")
        offsets_dev = torch.from_numpy(offsets.astype(np.int64)).to(device)

        def uniforms(t, ids, u: torch.Tensor) -> torch.Tensor:
            """``t`` and ``ids`` as host values (the loop driver) or device
            tensors (a chunk's round body)."""
            if not isinstance(t, torch.Tensor):
                if u.device.type != "cuda":
                    return torch.from_numpy(self.rounding_uniforms(t, ids, offsets))
                t = torch.tensor(int(t), dtype=torch.int64).to(u.device)
                ids = torch.from_numpy(np.asarray(ids, np.int64)).to(u.device)
            return kops.rounding_uniforms(self.seed, t, ids, offsets_dev, d)

        def apply(t, ids, u: torch.Tensor) -> torch.Tensor:
            unif = uniforms(t, ids, u)
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
