"""``cross_gram`` (U Vᵀ) and ``gram`` (U Uᵀ): CUDA kernels and plain versions.

Replace the reference's Pallas kernels ``src/repro/kernels/gram.py``
``cross_gram`` (``_xgram_kernel``) and ``gram`` (``_gram_kernel``).  At the
main path's shapes (K = 10 fresh updates against Q = 100 stored rows over
D = 595,914: 4.5 FLOP per byte read) bytes bound them; at the async round's
K = 30 the FMAs come close.  Every call is one launch (``csrc/gram.cu``):
the blocks split D, accumulate in fp32 FMA (no TF32), and sum their partials
in a fixed order in the same launch, the last blocks to arrive on arrival
counters adding them up (bitwise repeatable, no float atomics).
``cross_gram`` takes one of two kernels, as ``plan_cross_gram`` decides from
the shape and the card: for K ≤ 16 the stream kernel, whose lanes walk
columns of all K rows of U and 4 rows of V a warp straight from global
memory; for larger K the ring kernel, whose blocks hold all K rows of U (64
a tile) and up to 128 rows of V, copy each slab of them into a
shared-memory ring by ``cp.async`` and keep 8 x 8 register tiles of sums,
so that U and V each cross device memory once for Q ≤ 128.  ``gram`` with
P ≤ ``MAX_TRI_ROWS`` = 16 and 16-byte-aligned data sums the upper triangle
only and writes both halves of the square from the same values; other P or
data take a cross kernel with u = v (the ring kernel copying each slab once
for both operands).  See the source for the design.

``*_plain`` are the same functions in plain PyTorch: the CPU path, and the
yardstick the kernels are held against on the card.
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

#: launches of each kernel by its wrapper (nothing else touches them)
CROSS_GRAM_LAUNCHES = 0
GRAM_LAUNCHES = 0
#: of GRAM_LAUNCHES, those that ran as a cross kernel (P > 16 or unaligned
#: data): on the device they are cross_gram_ring_kernel or
#: cross_gram_stream_kernel launches
GRAM_VIA_CROSS = 0

MAX_TRI_ROWS = 16      # csrc/gram.cu kMaxTriRows: above it gram takes the cross kernel
TRI_THREADS = 256      # csrc/gram.cu kTriThreads
TRI_SLAB = 512         # csrc/gram.cu kSlab: columns a block streams per stage
TRI_MIN_SLABS = 4      # each block of the triangle kernel takes at least this many slabs

STREAM_MAX_K = 16      # K <= 16 takes cross_gram_stream_kernel, more K cross_gram_ring_kernel
STREAM_TILES = (4, 8, 12, 16)   # its compile-time U rows a lane: the smallest that holds K
STREAM_MAX_WARPS = 8   # csrc/gram.cu kMaxStreamWarps
STREAM_ROWS_PER_WARP = 4        # V rows a warp: csrc/gram.cu kRowsPerWarp
STREAM_MIN_VECS = 4    # csrc/gram.cu kMinVecsPerLane: loads a lane walks at least

#: a ring block's warps: 12 (three a scheduler) where they split the tile
#: and the columns evenly, else 8 (csrc/gram.cu kRingMaxWarps)
RING_WARPS = (12, 8)
RING_TILE = 8          # csrc/gram.cu kRingRK = kRingRQ: a lane's 8 x 8 sums, a warp's 32 x 32
CROSS_MAX_QT = 128     # V rows a ring block holds at most: larger Q takes more tiles
CROSS_SLABS = (512, 256, 128, 64, 32)    # columns a stage holds, the widest that fits first
CROSS_ROW_PAD = 8      # csrc/gram.cu kRowPad: floats a stage row takes past its slab
CROSS_MIN_STAGES = 3   # slabs in the ring at the least, two in flight while one is summed
CROSS_MAX_STAGES = 8   # csrc/gram.cu kMaxCrossStages
#: dynamic shared memory a block plans for: the card's 227 KB a block, less
#: 2 KB for the kernel's static shared memory (its table of row addresses)
CROSS_SMEM_BUDGET = 227 * 1024 - 2048


def cross_gram_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u.float() @ v.float().T


def gram_plain(u: torch.Tensor) -> torch.Tensor:
    u32 = u.float()
    return u32 @ u32.T


def check_cuda_f32(name: str, t: torch.Tensor, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous fp32 CUDA tensor of rank ``ndim``
    on the current device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.device.index is not None and t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: tensor on {t.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def vec_width(d: int, *tensors: torch.Tensor) -> int:
    """Widest load (4, 2 or 1 floats) that keeps every row start aligned."""
    for vec in (4, 2):
        if d % vec == 0 and all(t.data_ptr() % (4 * vec) == 0 for t in tensors):
            return vec
    return 1


def tri_tile(p: int) -> int:
    """Rows of the triangle kernel's compile-time tile for P rows: the
    smallest of 4, 8, 12, 16 that holds P (0 above 16: a cross kernel)."""
    if p < 1:
        raise ValueError(f"tri_tile: P={p}")
    return next((t for t in (4, 8, 12, 16) if p <= t), 0)


def plan_gram_splits(d: int, sms: int, per_sm: int) -> int:
    """Blocks of the triangle kernel over D: at most one wave of the
    card's ``sms · per_sm`` resident blocks, each taking at least
    ``TRI_MIN_SLABS`` of the 512-column slabs where D allows (the blocks
    take the slabs in turn)."""
    if min(d, sms, per_sm) < 1:
        raise ValueError(f"plan_gram_splits: D={d}, SMs={sms}, blocks per SM={per_sm}")
    slabs = -(-d // TRI_SLAB)
    return max(1, min(sms * per_sm, slabs // TRI_MIN_SLABS))


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """How a ``gram`` call at P ≤ 16 is launched: one kernel of ``n_splits``
    blocks of ``TRI_THREADS``, taking the 512-column slabs in turn,
    ``blocks_per_sm`` of them resident on each of ``sms`` SMs, ``registers``
    a thread."""
    tile: int
    n_splits: int
    blocks_per_sm: int
    sms: int
    registers: int


@functools.lru_cache(maxsize=None)
def _tri_occupancy(index: int, tile: int) -> Tuple[int, int]:
    per_sm, regs = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = build.library().flrce_gram_occupancy(tile, ctypes.byref(per_sm), ctypes.byref(regs))
    build.check(rc, "gram occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"gram: the instance (tile {tile}) fits no block on an SM")
    return per_sm.value, regs.value


def one_launch(u: torch.Tensor) -> bool:
    """Whether ``gram`` of u takes the triangle kernel: P ≤ 16 and the data
    16-byte aligned (its bulk copies start at 16-byte floors)."""
    return u.shape[0] <= MAX_TRI_ROWS and u.data_ptr() % 16 == 0


def gram_plan(u: torch.Tensor) -> GramPlan:
    """The triangle kernel's plan for u (P ≤ 16, D) on the card."""
    if not one_launch(u):
        raise ValueError(f"gram_plan: u {tuple(u.shape)} takes the cross kernel")
    p, d = u.shape
    return _gram_plan(device_index(u.device), tri_tile(p), d)


@functools.lru_cache(maxsize=1024)
def _gram_plan(index: int, tile: int, d: int) -> GramPlan:
    per_sm, regs = _tri_occupancy(index, tile)
    sms = sm_count(index)
    return GramPlan(tile=tile, n_splits=plan_gram_splits(d, sms, per_sm), blocks_per_sm=per_sm,
                    sms=sms, registers=regs)


@dataclasses.dataclass(frozen=True)
class CrossPlan:
    """How a ``cross_gram`` call is launched: ``route`` "stream" (K ≤ 16) or
    "ring", over n_kt x n_qt tiles of ``kt`` U rows and ``qt`` V rows, each
    taken by ``n_splits`` blocks whose partial sums add up in groups of
    ``group``.  The stream kernel: ``warps`` warps a block, each split a
    chunk of ``chunk`` columns, loads ``vec`` floats wide.  The ring kernel:
    ``warps`` warps a block (``wk`` x ``wq`` over the tile, ``wc`` over the
    columns) taking the ``slab``-column slabs in turn through a
    ring of ``stages`` stages of ``stage_bytes`` (``smem`` bytes of dynamic
    shared memory in all); ``same``: u is v, one copy of each slab.  On the
    card, ``blocks_per_sm`` blocks are resident on each of ``sms`` SMs at
    ``registers`` a thread (0 where not queried)."""
    route: str
    kt: int
    qt: int
    n_kt: int
    n_qt: int
    n_splits: int
    group: int
    n_groups: int
    slot: int
    sms: int
    blocks_per_sm: int
    vec: int = 0
    warps: int = 0
    chunk: int = 0
    wk: int = 0
    wq: int = 0
    wc: int = 0
    slab: int = 0
    stages: int = 0
    stage_bytes: int = 0
    smem: int = 0
    same: bool = False
    registers: int = 0

    @property
    def tiles(self) -> int:
        return self.n_kt * self.n_qt

    @property
    def blocks(self) -> int:
        return self.tiles * self.n_splits

    @property
    def counters(self) -> int:
        """int32 arrival counters the launch needs: one a group and one for
        the groups, each tile."""
        return self.tiles * (self.n_groups + 1)

    @property
    def partial_floats(self) -> int:
        return self.tiles * self.n_splits * self.slot


def plan_cross_gram(k: int, q: int, d: int, sms: int, per_sm: int, same: bool = False,
                    vec: int = 4) -> CrossPlan:
    """The cross kernels' launch for (K, D) × (Q, D) on a card of ``sms`` SMs
    holding ``per_sm`` blocks each, the data allowing loads ``vec`` floats
    wide.  K ≤ 16, the stream kernel: the smallest U tile that holds K, the
    fewest warps (4 V rows each, at most 8) that hold Q, and D cut so that
    one wave of blocks covers the V tiles, each lane walking at least
    ``STREAM_MIN_VECS`` loads.  More K, the ring kernel: 32 U rows a warp
    (two warps past 32, more tiles past 64), the fewest warps over V rows
    that hold Q (at most ``CROSS_MAX_QT`` rows a tile), the rest of 12
    warps (8 where 12 do not divide evenly) splitting the columns; the
    widest slab whose stages fit
    ``CROSS_MIN_STAGES`` times in ``CROSS_SMEM_BUDGET``, then as many stages
    as fit (at most ``CROSS_MAX_STAGES``); one wave of blocks, each tile's
    split over at most all the slabs.  Both sum their splits in groups of
    ⌈√n_splits⌉.  ``same`` (u is v) asks K = Q and copies each slab's rows
    once."""
    if min(k, q, d, sms, per_sm) < 1 or vec not in (1, 2, 4):
        raise ValueError(f"plan_cross_gram: K={k}, Q={q}, D={d}, SMs={sms}, "
                         f"blocks per SM={per_sm}, vec={vec}")
    if same and k != q:
        raise ValueError(f"plan_cross_gram: same operand with K={k} != Q={q}")

    def groups(n_splits):
        group = math.isqrt(n_splits - 1) + 1                 # ⌈√n_splits⌉
        return dict(n_splits=n_splits, group=group, n_groups=-(-n_splits // group))

    if k <= STREAM_MAX_K:
        kt = next(t for t in STREAM_TILES if k <= t)
        warps = min(STREAM_MAX_WARPS, -(-q // STREAM_ROWS_PER_WARP))
        qt = STREAM_ROWS_PER_WARP * warps
        n_qt = -(-q // qt)
        step = 32 * vec
        splits = max(1, min(sms * per_sm // n_qt, -(-d // (step * STREAM_MIN_VECS))))
        chunk = -(-(-(-d // splits)) // step) * step
        return CrossPlan(route="stream", kt=kt, qt=qt, n_kt=1, n_qt=n_qt, slot=k * min(q, qt),
                         sms=sms, blocks_per_sm=per_sm, vec=vec, warps=warps, chunk=chunk,
                         **groups(-(-d // chunk)))
    wk = 1 if k <= 4 * RING_TILE else 2
    kt = 4 * RING_TILE * wk
    most_wq = min(RING_WARPS[-1] // wk, CROSS_MAX_QT // (4 * RING_TILE))
    wq = 1
    while wq < most_wq and 4 * RING_TILE * wq < q:
        wq *= 2
    qt = 4 * RING_TILE * wq
    n_kt, n_qt = -(-k // kt), -(-q // qt)
    same = same and n_kt == n_qt == 1
    kn, qn = min(k, kt), min(q, qt)
    rows = kn if same else kn + qn
    slab = next((s for s in CROSS_SLABS
                 if CROSS_SMEM_BUDGET // (rows * (s + CROSS_ROW_PAD) * 4) >= CROSS_MIN_STAGES),
                CROSS_SLABS[-1])
    stage_bytes = rows * (slab + CROSS_ROW_PAD) * 4
    stages = min(CROSS_MAX_STAGES, CROSS_SMEM_BUDGET // stage_bytes)
    warps = next(w for w in RING_WARPS if w % (wk * wq) == 0)
    wc = warps // (wk * wq)
    smem = max(stages * stage_bytes, wc * kt * qt * 4)   # the ring, reused for the block's sum
    n_splits = max(1, min(-(-d // slab), sms * per_sm // (n_kt * n_qt)))
    return CrossPlan(route="ring", kt=kt, qt=qt, n_kt=n_kt, n_qt=n_qt, slot=kn * qn, sms=sms,
                     blocks_per_sm=per_sm, warps=warps, wk=wk, wq=wq, wc=wc, slab=slab,
                     stages=stages,
                     stage_bytes=stage_bytes, smem=smem, same=same, **groups(n_splits))


@functools.lru_cache(maxsize=None)
def _cross_occupancy(index: int, route: str, vec: int, kt: int, warps: int,
                     smem: int) -> Tuple[int, int]:
    per_sm, regs, most = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib = build.library()
    with torch.cuda.device(index):
        if route == "stream":
            rc = lib.flrce_cross_gram_stream_occupancy(vec, kt, warps, ctypes.byref(per_sm),
                                                       ctypes.byref(regs))
        else:
            rc = lib.flrce_cross_gram_ring_occupancy(warps, smem, ctypes.byref(per_sm),
                                                     ctypes.byref(regs), ctypes.byref(most))
    build.check(rc, "cross_gram occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"cross_gram: the {route} kernel fits no block on an SM "
                           f"({smem} B of shared memory asked, {most.value} B at most)")
    return per_sm.value, regs.value


@functools.lru_cache(maxsize=1024)
def _cross_plan(index: int, k: int, q: int, d: int, same: bool, vec: int) -> CrossPlan:
    sms = sm_count(index)
    first = plan_cross_gram(k, q, d, sms, 1, same, vec)
    per_sm, regs = _cross_occupancy(index, first.route, first.vec, first.kt, first.warps,
                                    first.smem)
    return dataclasses.replace(plan_cross_gram(k, q, d, sms, per_sm, same, vec), registers=regs)


def cross_plan(u: torch.Tensor, v: torch.Tensor) -> CrossPlan:
    """The cross kernels' plan for u (K, D) and v (Q, D) on the card."""
    (k, d), q = u.shape, v.shape[0]
    same = u.data_ptr() == v.data_ptr() and u.shape == v.shape
    return _cross_plan(device_index(u.device), k, q, d, same, vec_width(d, u, v))


def _check_pair(u: torch.Tensor, v: torch.Tensor) -> None:
    k, d = u.shape
    q = v.shape[0]
    if d < 1 or k < 1 or q < 1:
        raise ValueError(f"empty operand: u {tuple(u.shape)}, v {tuple(v.shape)}")
    if v.shape[1] != d:
        raise ValueError(f"dim mismatch {tuple(u.shape)} vs {tuple(v.shape)}")


def _launch_cross(u: torch.Tensor, v: torch.Tensor, what: str) -> torch.Tensor:
    (k, d), q = u.shape, v.shape[0]
    plan = cross_plan(u, v)
    out = torch.empty((k, q), dtype=torch.float32, device=u.device)
    partial = torch.empty(plan.partial_floats, dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device)
    arrival = arrival_counters(u.device, stream, plan.counters)
    lib = build.library()
    pointers = (u.data_ptr(), v.data_ptr(), partial.data_ptr(), arrival.data_ptr(), out.data_ptr())
    if plan.route == "stream":
        rc = lib.flrce_cross_gram_stream(*pointers, k, q, d, plan.kt, plan.vec, plan.warps,
                                         plan.n_splits, plan.chunk, plan.group, stream.cuda_stream)
    else:
        rc = lib.flrce_cross_gram_ring(*pointers, k, q, d, plan.wk, plan.wq, plan.wc, plan.slab,
                                       plan.stages, plan.n_splits, plan.group, plan.smem,
                                       int(plan.same), stream.cuda_stream)
    build.check(rc, what)
    return out


def cross_gram_cuda(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(K, D) × (Q, D) → (K, Q) fp32 on the card, in one launch."""
    global CROSS_GRAM_LAUNCHES
    check_cuda_f32("cross_gram u", u, 2)
    check_cuda_f32("cross_gram v", v, 2)
    if u.device != v.device:
        raise ValueError(f"cross_gram: u on {u.device}, v on {v.device}")
    _check_pair(u, v)
    out = _launch_cross(u, v, "cross_gram")
    CROSS_GRAM_LAUNCHES += 1
    return out


def gram_cuda(u: torch.Tensor) -> torch.Tensor:
    """(P, D) → (P, P) fp32 on the card, in one launch: the triangle kernel
    for P ≤ 16 (16-byte aligned data), a cross kernel with u = v
    otherwise."""
    global GRAM_LAUNCHES, GRAM_VIA_CROSS
    check_cuda_f32("gram u", u, 2)
    _check_pair(u, u)
    p, d = u.shape
    if one_launch(u):
        plan = gram_plan(u)
        out = torch.empty((p, p), dtype=torch.float32, device=u.device)
        partial = torch.empty((plan.n_splits, p * (p + 1) // 2), dtype=torch.float32,
                              device=u.device)
        stream = torch.cuda.current_stream(u.device)
        arrival = arrival_counters(u.device, stream, 1)
        rc = build.library().flrce_gram(u.data_ptr(), partial.data_ptr(), arrival.data_ptr(),
                                        out.data_ptr(), p, d, plan.n_splits, stream.cuda_stream)
        build.check(rc, "gram")
    else:
        out = _launch_cross(u, u, "gram")
        GRAM_VIA_CROSS += 1
    GRAM_LAUNCHES += 1
    return out
