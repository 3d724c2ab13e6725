"""Client stores and batch schedules for the compiled round driver.

The loop driver builds and copies a fresh ``(P, S, B, *feat)`` cohort plan
every round.  The compiled driver (``fl/scan_driver.py``) instead keeps the
federation's samples stacked as ``(M, N_max, …)`` tensors and sends, per
chunk of rounds, only int32 batch-index schedules; each local step gathers
its ``(P, B, …)`` batch from the store on the device.

* :class:`DeviceClientStore` — the whole universe on the device, copied once.
* :class:`HostClientStore` — the universe in host memory; :meth:`page`
  gathers only a chunk's candidate rows, which the chunk indexes by *slot*
  (position in the candidate set).  Device memory is then O(P_cand).

Host copies go through :class:`PinnedStager`: pinned host buffers, copied
with ``non_blocking=True`` on a copy stream that the compute stream waits on
by event.  A pinned buffer is refilled only after its last copy completed.

Schedules are drawn from the same ``client_batch_rng(seed, t, cid)`` streams
as ``fl/client.py`` ``build_cohort_plan``, consumed in the same order, so a
gathered cohort is bitwise the loop driver's plan.  Host index arithmetic is
int64 (:func:`flat_row_index`): ``M · N_max`` passes int32 at fleet scale.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.loader import bucket_steps as _bucket_steps
from repro_torch.data.synthetic import FederatedDataset

_INT32_MAX = np.iinfo(np.int32).max


def validate_store_geometry(m: int, n_max: int) -> None:
    """Reject store shapes whose index arithmetic cannot be represented:
    sample positions must fit int32 (schedules are int32) and the flat
    ``m · n_max`` row space int64."""
    if m < 0 or n_max < 0:
        raise ValueError(f"store geometry must be non-negative, got M={m}, N_max={n_max}")
    if n_max > _INT32_MAX:
        raise ValueError(f"N_max={n_max} exceeds int32; batch schedules index samples in int32")
    if int(m) * int(n_max) > np.iinfo(np.int64).max:
        raise ValueError(f"M·N_max={m}·{n_max} overflows int64 flat indexing")


def flat_row_index(cids: np.ndarray, pos: np.ndarray, n_max: int) -> np.ndarray:
    """(client, sample) → row of the ``(M · N_max, …)`` view, always int64."""
    cids = np.asarray(cids, np.int64)
    pos = np.asarray(pos, np.int64)
    return cids * np.int64(n_max) + pos


class PinnedStager:
    """Host → device copies of a chunk's inputs, double-buffered.

    :meth:`buffer` hands out host arrays to fill; :meth:`send` copies them
    to fresh device tensors and returns them with an event the consumer's
    stream waits on.  On CUDA the host arrays are views of pinned buffers,
    one set per slot, and the copies run with ``non_blocking=True`` on the
    stager's own stream; a slot is refilled only after the copies from its
    last use completed.
    The device tensors are recorded on ``consumer`` so the allocator does not
    hand their memory out again before the consumer has read them.  On the
    CPU the host arrays are plain NumPy and :meth:`send` wraps them.
    """

    def __init__(self, device: torch.device, consumer: Optional["torch.cuda.Stream"] = None):
        slots = 2            # the pipeline's depth
        self.device = device
        self.cuda = device.type == "cuda"
        self.consumer = consumer
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._pinned: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
        self._done: List[Optional["torch.cuda.Event"]] = [None] * slots
        self._slot = slots - 1
        self._open: Dict[str, torch.Tensor] = {}
        self.bytes_sent = 0

    def begin(self) -> None:
        """Start filling the next slot, waiting for its last copies if needed."""
        self._slot = (self._slot + 1) % len(self._pinned)
        self._open = {}
        done = self._done[self._slot]
        if done is not None:
            done.synchronize()

    def buffer(self, name: str, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """A host array of ``shape`` for input ``name`` of the open slot."""
        dtype = np.dtype(dtype)
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        numel = int(np.prod(shape, dtype=np.int64))
        if self.cuda:
            pinned = self._pinned[self._slot]
            buf = pinned.get(name)
            if buf is None or buf.numel() < numel or buf.dtype != tdtype:
                buf = pinned[name] = torch.empty(numel, dtype=tdtype, pin_memory=True)
            host = buf[:numel].view(shape)
        else:
            host = torch.from_numpy(np.empty(shape, dtype))
        self._open[name] = host
        return host.numpy()

    def send(self) -> Tuple[Dict[str, torch.Tensor], Optional["torch.cuda.Event"]]:
        """Copy the open slot's arrays to the device: ``(tensors, ready event)``."""
        staged, self._open = self._open, {}
        self.bytes_sent += sum(t.numel() * t.element_size() for t in staged.values())
        if not self.cuda:
            return staged, None
        out: Dict[str, torch.Tensor] = {}
        with torch.cuda.stream(self.stream):
            for name, host in staged.items():
                dst = torch.empty(host.shape, dtype=host.dtype, device=self.device)
                dst.copy_(host, non_blocking=True)
                if self.consumer is not None:
                    dst.record_stream(self.consumer)
                out[name] = dst
            ready = torch.cuda.Event()
            ready.record(self.stream)
        self._done[self._slot] = ready
        return out, ready


@dataclasses.dataclass
class DeviceClientStore:
    """Every client's shard stacked into tensors on one device, padded to N_max
    (also a chunk's page of candidate rows, indexed by slot)."""

    x: torch.Tensor              # (M, N_max, *feat) float32
    y: torch.Tensor              # (M, N_max) int64
    sizes: torch.Tensor          # (M,) float64 — real samples per client (Eq. 4's n_k)
    sizes_host: np.ndarray       # (M,) int64

    @property
    def num_clients(self) -> int:
        return len(self.sizes_host)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.x, self.y, self.sizes))

    @classmethod
    def from_dataset(cls, ds: FederatedDataset, device) -> "DeviceClientStore":
        host = HostClientStore.from_dataset(ds)
        dev = torch.device(device)
        return cls(
            x=torch.from_numpy(host.x).to(dev),
            y=torch.from_numpy(host.y).to(dev, torch.int64),
            sizes=torch.from_numpy(host.sizes_host.astype(np.float64)).to(dev),
            sizes_host=host.sizes_host,
        )

    def gather_cohort(
        self,
        ids: torch.Tensor,          # (P,) schedule rows
        batch_idx: torch.Tensor,    # (M | P_cand, S, B) int — this round's schedule
        sample_w: torch.Tensor,     # (M | P_cand, S, B) float32
        step_valid: torch.Tensor,   # (M | P_cand, S) float32
        *,
        rows: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """A round's whole ``(x (P,S,B,*feat), y, sample_w, step_valid)`` —
        a :class:`CohortPlan`'s arrays.  ``ids`` index the schedules,
        ``rows`` (default ``ids``) the store.  The driver gathers one step
        at a time instead (:meth:`gather_step`): at the CIFAR width a round's
        batches are about 0.5 GB."""
        r = (ids if rows is None else rows).long()
        bi = batch_idx[ids.long()].long()
        return (self.x[r[:, None, None], bi], self.y[r[:, None, None], bi],
                sample_w[ids.long()], step_valid[ids.long()])

    def gather_step(self, rows: torch.Tensor, bi: torch.Tensor):
        """One local step's ``(x (P, B, *feat), y (P, B))`` for store rows
        ``rows`` (P,) and sample positions ``bi`` (P, B)."""
        r = rows.long()[:, None]
        bi = bi.long()
        return self.x[r, bi], self.y[r, bi]


@dataclasses.dataclass
class HostClientStore:
    """The ``(M, N_max, …)`` universe in host memory, paged by candidate set."""

    x: np.ndarray                # (M, N_max, *feat) float32
    y: np.ndarray                # (M, N_max) int32
    sizes_host: np.ndarray       # (M,) int64

    @property
    def num_clients(self) -> int:
        return len(self.sizes_host)

    @property
    def nbytes(self) -> int:
        return self.x.nbytes + self.y.nbytes

    @classmethod
    def from_dataset(cls, ds: FederatedDataset) -> "HostClientStore":
        """Stack every client shard into padded host arrays with one int64
        flat-index scatter (no per-client loop)."""
        sizes = ds.client_sizes().astype(np.int64)
        m = len(ds.client_indices)
        n_max = max(1, int(sizes.max()) if m else 1)
        validate_store_geometry(m, n_max)
        feat = ds.x.shape[1:]
        x = np.zeros((m, n_max, *feat), np.float32)
        y = np.zeros((m, n_max), np.int32)
        if m and sizes.sum():
            cat = np.concatenate([np.asarray(ix, np.int64) for ix in ds.client_indices])
            rows = np.repeat(np.arange(m, dtype=np.int64), sizes)
            starts = np.cumsum(sizes) - sizes
            pos = np.arange(int(sizes.sum()), dtype=np.int64) - np.repeat(starts, sizes)
            flat = flat_row_index(rows, pos, n_max)
            x.reshape(m * n_max, *feat)[flat] = ds.x[cat]
            y.reshape(m * n_max)[flat] = ds.y[cat]
        return cls(x=x, y=y, sizes_host=sizes)

    def page(self, cand: np.ndarray, stager: PinnedStager) -> int:
        """Stage candidate rows ``cand`` (P_cand,) as the open slot's
        ``page_x``, ``page_y`` and ``page_sizes``: row j is client
        ``cand[j]``.  Returns the page's bytes."""
        cand = np.asarray(cand, np.int64)
        px = stager.buffer("page_x", (len(cand), *self.x.shape[1:]), np.float32)
        py = stager.buffer("page_y", (len(cand), self.y.shape[1]), np.int64)
        np.take(self.x, cand, axis=0, out=px)
        py[...] = self.y[cand]
        stager.buffer("page_sizes", (len(cand),), np.float64)[...] = self.sizes_host[cand]
        return px.nbytes + py.nbytes


@dataclasses.dataclass
class ChunkSchedule:
    """Host-built batch schedules for a chunk of rounds [t0, t0 + R).

    The client axis is the chunk's candidate axis: column j schedules the
    j-th candidate (``client_ids[j]`` of :func:`build_chunk_schedule`).
    """

    t0: int
    batch_idx: np.ndarray     # (R, P_cand, S, B) int32 — positions in a store row
    sample_w: np.ndarray      # (R, P_cand, S, B) float32: 1 = real sample, 0 = pad
    step_valid: np.ndarray    # (R, P_cand, S) float32: 1 = real step, 0 = pad

    @property
    def num_steps(self) -> int:
        return self.batch_idx.shape[2]

    @property
    def nbytes(self) -> int:
        return self.batch_idx.nbytes + self.sample_w.nbytes + self.step_valid.nbytes


def place_schedule(sched: ChunkSchedule, stager: PinnedStager) -> None:
    """Stage a chunk's schedules as the open slot's ``batch_idx``,
    ``sample_w`` and ``step_valid`` (sent with the slot's other inputs)."""
    for name in ("batch_idx", "sample_w", "step_valid"):
        a = getattr(sched, name)
        np.copyto(stager.buffer(name, a.shape, a.dtype), a)


# (cache_key, t, cid, n, e, batch_size) → one client's schedule.  A schedule
# is a pure function of its stream, so equivalence runs that build the same
# chunks twice reuse the draws; FIFO-bounded, since one long job inserts
# round keys it never reads again.
_SCHEDULE_MEMO: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}
_SCHEDULE_MEMO_MAX = 4096


def clear_schedule_memo() -> None:
    _SCHEDULE_MEMO.clear()


def _memo_put(key: tuple, val: Tuple[np.ndarray, np.ndarray]) -> None:
    while len(_SCHEDULE_MEMO) >= _SCHEDULE_MEMO_MAX:
        _SCHEDULE_MEMO.pop(next(iter(_SCHEDULE_MEMO)))
    _SCHEDULE_MEMO[key] = val


def _client_schedule(n: int, e: int, batch_size: int, rng_k: np.random.Generator
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """One (t, client) schedule ``(idx (s_k, B) int32, w (s_k, B) f32)``:
    one permutation per epoch in epoch order (the stream's contract), the
    epoch's last batch padded."""
    nb = -(-n // batch_size) if n else 0
    s_k = e * nb
    if s_k == 0:
        return np.zeros((0, batch_size), np.int32), np.zeros((0, batch_size), np.float32)
    perms = np.stack([rng_k.permutation(n) for _ in range(e)])        # (e, n)
    pad = nb * batch_size - n
    idx = np.pad(perms, ((0, 0), (0, pad))).reshape(s_k, batch_size)
    w = np.pad(np.ones((e, n), np.float32), ((0, 0), (0, pad)))
    return idx.astype(np.int32), w.reshape(s_k, batch_size)


def build_chunk_schedule(
    sizes: np.ndarray,                       # (P_cand,) samples per candidate
    epochs: np.ndarray,                      # (R, P_cand) local epochs
    batch_size: int,
    t0: int,
    rng_for: Callable[[int, int], np.random.Generator],
    *,
    bucket_steps: bool = True,
    cache_key: Optional[int] = None,
    client_ids: Optional[np.ndarray] = None,
) -> ChunkSchedule:
    """Draw every (round, candidate) batch schedule of a chunk.

    ``rng_for(t, cid)`` must be the loop driver's stream
    (``client_batch_rng``), keyed by the global id ``client_ids[col]``
    (default: the column).  The step axis is the chunk's longest schedule,
    bucketed to a power of two.  ``cache_key`` (the job seed) turns on the
    schedule memo.
    """
    sizes = np.asarray(sizes)
    epochs = np.asarray(epochs)
    r_rounds, m = epochs.shape
    if len(sizes) != m:
        raise ValueError(f"sizes has {len(sizes)} clients, epochs has {m}")
    if client_ids is not None and len(client_ids) != m:
        raise ValueError(f"client_ids has {len(client_ids)} entries, epochs has {m} columns")
    per_round = []
    s_max = 1
    for r in range(r_rounds):
        t = t0 + r
        per_client = []
        for col in range(m):
            cid = int(client_ids[col]) if client_ids is not None else col
            n = int(sizes[col])
            e = max(1, int(epochs[r, col]))
            memo_key = (cache_key, t, cid, n, e, batch_size)
            if cache_key is not None and memo_key in _SCHEDULE_MEMO:
                idx, w = _SCHEDULE_MEMO[memo_key]
            else:
                idx, w = _client_schedule(n, e, batch_size, rng_for(t, cid))
                if cache_key is not None:
                    _memo_put(memo_key, (idx, w))
            per_client.append((idx, w))
            s_max = max(s_max, idx.shape[0])
        per_round.append(per_client)

    s_pad = _bucket_steps(s_max) if bucket_steps else s_max
    batch_idx = np.zeros((r_rounds, m, s_pad, batch_size), np.int32)
    sample_w = np.zeros((r_rounds, m, s_pad, batch_size), np.float32)
    step_valid = np.zeros((r_rounds, m, s_pad), np.float32)
    for r, per_client in enumerate(per_round):
        for col, (idx, w) in enumerate(per_client):
            s_k = idx.shape[0]
            batch_idx[r, col, :s_k] = idx
            sample_w[r, col, :s_k] = w
            step_valid[r, col, :s_k] = 1.0
    return ChunkSchedule(t0=t0, batch_idx=batch_idx, sample_w=sample_w, step_valid=step_valid)
