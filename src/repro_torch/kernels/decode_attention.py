"""``decode_attention`` (one-query GQA attention over a KV cache): CUDA kernel
and plain version.

Replaces the reference's Pallas kernel ``src/repro/kernels/decode_attention.py``
``decode_attention`` (``_decode_attn_kernel``) and covers the ``window`` /
``ring`` masks of ``decode_attention_jnp`` (``src/repro/models/attention.py``),
the function the reference's serving path calls.  q (B, H, hd), caches
(B, S, K, hd), length (B,) int32 with the current token already written:

* ``ring=True``: slot < min(length, S) is valid (a ring-buffer cache);
* otherwise slot < length, and with ``window > 0`` also slot ≥ length − window;
* logits are (q·1/√hd) · K in fp32, masked to -1e30, softmax over S; the
  output is Σ p·V in fp32, cast to q's dtype.

Length 0 (no valid slot): every logit is -1e30, so the softmax is uniform and
the output is the mean of V over all S slots.  That is what
``decode_attention_jnp`` gives; the reference's oracle ``decode_attention_ref``
gives NaN there and its Pallas kernel the mean over the zero-padded S.  The
port follows the function the serving path calls.

Decoding is memory-bound (about 2 FLOP per byte of cache).  The kernel
(``csrc/decode_attention.cu``, whose source note gives the design) is split-S
flash-decoding written for Hopper, in one launch: one block per (split of the
valid range, KV head, sequence), every K/V row read once for the G query
heads of its group, the rows streamed by bulk copies into a shared-memory
ring per warp, and the last block of each (sequence, KV head) to finish
combining the splits in a fixed order (bitwise repeatable).  Slots outside
the valid range are never read; masked logits contribute exactly 0 in the
reference, so this changes nothing.  A block holds at most 8 query heads in
registers; a group of 9..16 (recurrentgemma-2b's 10 heads over one KV head)
runs as two sub-groups of ``ceil(G / 2)`` heads, each a block of its own
(``subgroups``), as the Pallas kernel's one block per KV head takes any
group.

The wrapper plans the grid from the occupancy the kernel really gets
(``plan_splits``): at most one wave of resident blocks, no split under
``_MIN_ROWS`` rows.  The splits of a (sequence, KV head) meet on an int32
arrival counter (``kernels/grid.py``: per (device, stream), zero at
rest, grown when a batch needs more).

``decode_attention_plain`` is the same function in plain PyTorch: the CPU
path, and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grid import arrival_counters, device_index, sm_count

#: launches of the kernel by its wrapper (nothing else touches it)
DECODE_ATTENTION_LAUNCHES = 0

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16          # query heads per KV head
MAX_BLOCK_GROUP = 8     # query heads one block holds: the instances G 1..8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_MIN_ROWS = 64          # csrc/decode_attention.cu kMinRows
_MAX_SPLITS = 512       # csrc/decode_attention.cu kMaxSplits

def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           length: torch.Tensor, *, window: int = 0,
                           ring: bool = False) -> torch.Tensor:
    """``decode_attention_jnp`` in PyTorch: (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    group = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).reshape(b, kvh, group, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    slot = torch.arange(s, device=q.device)[None, :]
    length = length.to(device=q.device, dtype=torch.int64)
    if ring:
        valid = slot < torch.clamp(length, max=s)[:, None]
    else:
        valid = slot < length[:, None]
        if window > 0:
            valid = valid & (slot >= length[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(_NEG_INF, dtype=torch.float32, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, dtype_code: int, hd: int, group: int) -> Tuple[int, int]:
    """(blocks per SM, dynamic shared memory bytes) of the kernel instance on
    device ``index``, as the CUDA occupancy query gives them."""
    per_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = build.library().flrce_decode_attention_occupancy(
            dtype_code, hd, group, ctypes.byref(per_sm), ctypes.byref(smem))
    build.check(rc, "decode_attention occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"decode_attention: the instance (dtype {dtype_code}, hd {hd}, "
                           f"G {group}) fits no block on an SM")
    return per_sm.value, smem.value


def subgroups(group: int) -> Tuple[int, int]:
    """(sub-groups per KV head, query heads a block holds) for ``group``
    query heads per KV head: one sub-group up to ``MAX_BLOCK_GROUP``, else
    the fewest equal sub-groups that fit (the last may hold one dummy head)."""
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"decode_attention: a group of {group} query heads is not in "
                         f"1..{MAX_GROUP}")
    n_sub = -(-group // MAX_BLOCK_GROUP)
    return n_sub, -(-group // n_sub)


def plan_splits(b: int, k: int, rows: int, sms: int, per_sm: int) -> int:
    """Splits of the valid range per (sequence, KV head): as many as one wave
    of the card's ``sms · per_sm`` resident blocks holds for the ``b · k``
    pairs, so no block waits for a second wave, but none shorter than
    ``_MIN_ROWS`` of the ``rows`` slots a range can hold."""
    if min(b, k, sms, per_sm) < 1:
        raise ValueError(f"plan_splits: B={b}, K={k}, SMs={sms}, blocks per SM={per_sm}")
    return max(1, min((sms * per_sm) // (b * k), rows // _MIN_ROWS, _MAX_SPLITS))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a call is launched: one kernel, grid (n_splits, K·n_sub, B) of
    128-thread blocks of ``block_group`` query heads, ``blocks_per_sm`` of
    them resident on each of ``sms`` SMs."""
    n_splits: int
    grid: Tuple[int, int, int]
    blocks_per_sm: int
    sms: int
    smem_bytes: int
    n_sub: int
    block_group: int


def launch_plan(q: torch.Tensor, k_cache: torch.Tensor, *, window: int = 0,
                ring: bool = False) -> LaunchPlan:
    """The grid the kernel gets for these operands (on the card)."""
    b, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    index = device_index(q.device)
    rows = min(s, window) if (window > 0 and not ring) else s
    return _plan(index, _DTYPES[q.dtype], b, kvh, h // kvh, hd, rows)


@functools.lru_cache(maxsize=1024)
def _plan(index: int, dtype_code: int, b: int, kvh: int, group: int, hd: int,
          rows: int) -> LaunchPlan:
    n_sub, block_group = subgroups(group)
    per_sm, smem = _occupancy(index, dtype_code, hd, block_group)
    sms = sm_count(index)
    n = plan_splits(b, kvh * n_sub, rows, sms, per_sm)
    return LaunchPlan(n_splits=n, grid=(n, kvh * n_sub, b), blocks_per_sm=per_sm, sms=sms,
                      smem_bytes=smem, n_sub=n_sub, block_group=block_group)


def _check_operand(name: str, t: torch.Tensor, ndim: int, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"decode_attention {name}: expected a CUDA tensor, got device {t.device}")
    if t.device.index is not None and t.device.index != torch.cuda.current_device():
        raise ValueError(f"decode_attention {name}: tensor on {t.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if t.dtype != dtype:
        raise ValueError(f"decode_attention {name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"decode_attention {name}: expected rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"decode_attention {name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"decode_attention {name}: data pointer not 16-byte aligned")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          length: torch.Tensor, *, window: int = 0,
                          ring: bool = False) -> torch.Tensor:
    """(B, H, hd) on the card; bf16 or fp32, hd ∈ {64, 128, 256}, H/K ≤ 16."""
    global DECODE_ATTENTION_LAUNCHES
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not in {list(_DTYPES)}")
    _check_operand("q", q, 3, q.dtype)
    _check_operand("k_cache", k_cache, 4, q.dtype)
    _check_operand("v_cache", v_cache, 4, q.dtype)
    _check_operand("length", length, 1, torch.int32)
    b, h, hd = q.shape
    bs, s, kvh, hdk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or bs != b or hdk != hd or length.shape[0] != b:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}, length {tuple(length.shape)} do not agree")
    if not (q.device == k_cache.device == v_cache.device == length.device):
        raise ValueError("decode_attention: operands on different devices")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if kvh < 1 or h % kvh or not 1 <= h // kvh <= MAX_GROUP:
        raise ValueError(f"decode_attention: H={h} over K={kvh} is not a group of 1..{MAX_GROUP}")
    if b < 1 or s < 1 or window < 0:
        raise ValueError(f"decode_attention: B={b}, S={s}, window={window}")
    group = h // kvh
    plan = launch_plan(q, k_cache, window=window, ring=ring)
    n, units, width = plan.n_splits, kvh * plan.n_sub, plan.block_group
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device)
    if n > 1:
        part_acc = torch.empty((b, units, n, width, hd), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, units, n, width, 2), dtype=torch.float32, device=q.device)
        ptrs = (part_acc.data_ptr(), part_ml.data_ptr(),
                arrival_counters(q.device, stream, b * units).data_ptr())
    else:
        ptrs = (None, None, None)
    rc = build.library().flrce_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(), *ptrs,
        out.data_ptr(), b, s, kvh, group, width, hd, n, int(window), int(bool(ring)),
        _DTYPES[q.dtype], ctypes.c_float(1.0 / math.sqrt(hd)), stream.cuda_stream)
    build.check(rc, "decode_attention")
    DECODE_ATTENTION_LAUNCHES += 1
    return out
