"""``weighted_aggregate`` (Eq. 4, w + pᵀU): CUDA kernel and plain version.

Replaces the reference's Pallas kernel ``src/repro/kernels/aggregate.py``
``weighted_aggregate`` (``_aggregate_kernel``).  Memory-bound (2·P FLOP per
(P+2)·4 bytes moved), so the kernel (``csrc/aggregate.cu``) reads each update
row and w once and writes the result once, in a grid-stride pass with 8- or
16-byte loads where rows are aligned; the P weighted terms are summed in a
fixed order before w is added, as the reference groups them.

``weighted_aggregate_plain`` is the same function in plain PyTorch: the CPU
path, and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gram import check_cuda_f32, vec_width

#: launches of the kernel by its wrapper (nothing else touches it)
AGGREGATE_LAUNCHES = 0

_THREADS = 256
_BLOCKS_PER_SM = 8


def weighted_aggregate_plain(w: torch.Tensor, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """w + Σ_k p_k·u_k, the weighted rows added one at a time in row order and
    w last, as the kernel groups them.  So rows weighted 0 (an async round's
    empty ring slots) leave the sum bitwise unchanged; a BLAS product's
    reduction order depends on the row count."""
    u32, p32 = u.float(), p.float()
    acc = torch.zeros_like(w, dtype=torch.float32)
    for k in range(u32.shape[0]):
        acc = acc + p32[k] * u32[k]
    return w.float() + acc


def weighted_aggregate_cuda(w: torch.Tensor, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """w (D,), u (P, D), p (P,) → (D,) fp32 on the card."""
    global AGGREGATE_LAUNCHES
    check_cuda_f32("weighted_aggregate w", w, 1)
    check_cuda_f32("weighted_aggregate u", u, 2)
    check_cuda_f32("weighted_aggregate p", p, 1)
    if not (w.device == u.device == p.device):
        raise ValueError(f"weighted_aggregate: w on {w.device}, u on {u.device}, p on {p.device}")
    (d,) = w.shape
    n_clients, du = u.shape
    if du != d or p.shape[0] != n_clients:
        raise ValueError(
            f"shape mismatch: w {tuple(w.shape)}, u {tuple(u.shape)}, p {tuple(p.shape)}"
        )
    if d < 1 or n_clients < 1:
        raise ValueError(f"empty operand: w {tuple(w.shape)}, u {tuple(u.shape)}")
    lib = build.library()
    out = torch.empty((d,), dtype=torch.float32, device=w.device)
    vec = vec_width(d, w, u, out)
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    blocks = max(1, min(-(-(d // vec) // _THREADS), _BLOCKS_PER_SM * sms))
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = lib.flrce_weighted_aggregate(w.data_ptr(), u.data_ptr(), p.data_ptr(), out.data_ptr(),
                                      n_clients, d, blocks, vec, stream)
    build.check(rc, "weighted_aggregate")
    AGGREGATE_LAUNCHES += 1
    return out
