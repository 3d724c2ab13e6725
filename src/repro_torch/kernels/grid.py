"""What the one-wave kernels share: the card's SM count, and the int32
arrival counters of kernels whose last block to finish combines the other
blocks' partial results (``decode_attention``, ``gram``).

The counters are kept per (device, stream), zero at rest: each kernel adds
one per block and its last block sets the counter back to 0.  Launches on
one stream run in order, so the kernels of a stream share its buffer;
another stream gets its own, so concurrent launches never meet on one.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream handle) → int32 arrival counters, zero at rest
ARRIVALS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    """The (device, stream)'s int32 arrival counters, at least ``n`` of them,
    all zero between launches."""
    index = device_index(device)
    key = (index, stream.cuda_stream)
    buf = ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 256)
        buf = torch.zeros(size, dtype=torch.int32, device=torch.device("cuda", index))
        ARRIVALS[key] = buf
    return buf
