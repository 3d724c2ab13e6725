"""Compiled round driver: chunks of rounds replayed from a captured CUDA graph.

The loop driver dispatches every round from Python and reads the device
several times a round (losses, the conflict count, the heuristic, the
accuracy).  This driver runs a *chunk* of R rounds with one host sync:

* the federation's samples sit on the device once
  (:class:`DeviceClientStore`), or in host memory, paged per chunk
  (:class:`HostClientStore`, ``paged=True``);
* per chunk the host sends only index schedules, Alg. 2's draws and the
  variants' inputs (:class:`PinnedStager`: pinned buffers, a copy stream);
* one round — select (Alg. 2) → gather each step's batch → train → the
  update transform → Eq. 4 through ``kops.weighted_aggregate`` → the
  strategy's ``post_round`` (Alg. 1 ingest, Alg. 3) → evaluate → masked
  carry writes — is a body over fixed input and output buffers that reads
  the round index from a device counter and advances it.  On the card it is
  captured once per (variant, step bucket, candidate count) as a
  ``torch.cuda.CUDAGraph`` and replayed R times; on the CPU it runs eagerly;
* after the chunk the host copies the (R, …) outputs to pinned memory and
  waits for that copy: the chunk's one sync.  It then charges the ledger
  and writes the records.

With ``pipeline=True`` the loop is two deep: chunk k+1 is built, copied and
dispatched before the host waits on chunk k, so building and flushing
overlap the device.  That dispatch is speculative: the stop flag lives on
the device, a round after the stop changes nothing (every carry write is
masked by it), and the host drops the outputs of a chunk dispatched after
the stop unread.  Records, ledger and the written-back state are bitwise
those of ``pipeline=False``.

**Async rounds** (``async_rounds=AsyncConfig(...)``): the same body runs
staleness-aware rounds.  A ring of B = max_staleness + 1 pending cohorts
(updates, sample counts, ids, departure and landing rounds, a valid flag,
the departure model) lives on the device beside ``w``; the departing cohort
is written to slot ``t mod B``, the rows landing at ``t`` are aggregated by
the staleness-weighted Eq. 4 over the (B·P, D) buffer, the strategy's
``post_round_async`` ingests them, and they leave the ring.  Charges stay
at departure; each round's arrival histogram by staleness goes to the
ledger.  With ``max_staleness=0`` the run is bitwise the synchronous one.
Synchronous jobs run the body they always ran.

Dispatch runs under ``torch.cuda.set_sync_debug_mode("error")``: a hidden
sync there raises.  A capture that fails raises; nothing falls back to
eager replay.  Evaluation runs every round inside the graph (a graph has no
branch) and the accuracy is kept only where the loop driver evaluates; that
costs one forward pass over the eval set on rounds the loop would skip when
``eval_every > 1``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import flatten_params
from repro_torch.data.device import (
    DeviceClientStore,
    HostClientStore,
    PinnedStager,
    build_chunk_schedule,
    place_schedule,
)
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl.async_rounds import AsyncConfig, AsyncPlan, resolve_async_plan, staleness_of
from repro_torch.fl.client import (
    BatchedCohortTrainer,
    client_batch_rng,
    freeze_flags,
    mean_losses,
)
from repro_torch.fl.metrics import ResourceLedger
from repro_torch.fl.strategy import ScanProgram, TorchStrategy
from repro_torch.kernels import ops as kops
from repro_torch.models.cnn import param_count

Params = Dict[str, torch.Tensor]


def _whole(name: str) -> bool:
    """Chunk inputs copied whole; the others have a row per round."""
    return name == "cand" or name.startswith("page_")


def _bucket_candidates(n: int, cap: int) -> int:
    """A chunk's candidate count rounded up to a power of two, at most M, so
    host-selected chunks reuse a few graphs (pad slots repeat the last id
    and no slot points at them)."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


@contextlib.contextmanager
def _no_hidden_sync(on: bool):
    """Raise on any host sync inside (CUDA's sync debug mode)."""
    if not on:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _Program:
    """The round body of one key: its input and output buffers, and on the
    card the graph that replays it."""

    def __init__(self, inputs: Dict[str, torch.Tensor], outs: Dict[str, torch.Tensor],
                 counter: torch.Tensor):
        self.inputs = inputs
        self.outs = outs
        self.counter = counter
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.captured_launches: Dict[str, int] = {}
        self.replays = 0


class _ChunkRunner:
    """Owns the carry (flat w, stop flag, last accuracy, the strategy's
    carry), one :class:`_Program` per key and the compute stream."""

    def __init__(self, model, trainer: BatchedCohortTrainer, w: torch.Tensor, unflatten,
                 program: ScanProgram, transform, store: Optional[DeviceClientStore], *,
                 clients_per_round: int, eval_every: int, max_rounds: int, chunk_rounds: int,
                 eval_x: torch.Tensor, eval_y: torch.Tensor, capture: bool,
                 async_plan: Optional[AsyncPlan] = None):
        self.model, self.trainer = model, trainer
        self.w, self.unflatten = w, unflatten
        self.program, self.transform, self.store = program, transform, store
        self.p, self.r_max = clients_per_round, chunk_rounds
        self.eval_every, self.max_rounds = eval_every, max_rounds
        self.eval_x, self.eval_y = eval_x, eval_y
        self.device = w.device
        self.capture = capture
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.stopped = torch.zeros((), dtype=torch.bool, device=self.device)
        self.last_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        self.programs: Dict[tuple, _Program] = {}
        self.captures = 0
        self.capture_s = 0.0     # warm-up rounds and captures, host clock
        self.async_plan = async_plan
        self.ring: Dict[str, torch.Tensor] = {}
        if async_plan is not None:
            # the pending cohorts of async rounds, slot t mod B: written in
            # place by the body like ``w`` (landing -1: nothing lands)
            b, p, d, dev = async_plan.depth, clients_per_round, w.shape[0], self.device
            self.ring = {
                "u": torch.zeros((b, p, d), dtype=torch.float32, device=dev),
                "sizes": torch.zeros((b, p), dtype=torch.float64, device=dev),   # store.sizes
                "ids": torch.zeros((b, p), dtype=torch.int64, device=dev),
                "depart": torch.zeros((b, p), dtype=torch.int32, device=dev),
                "land": torch.full((b, p), -1, dtype=torch.int32, device=dev),
                "valid": torch.zeros((b, p), dtype=torch.bool, device=dev),
                "anchor": torch.zeros((b, d), dtype=torch.float32, device=dev),
            }
            self.taus = torch.arange(b, dtype=torch.int32, device=dev)
        if self.stream is not None:
            # the carry, the store and the eval set were made on the caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    # -- buffers ---------------------------------------------------------------
    def _new_program(self, staged: Dict[str, torch.Tensor]) -> _Program:
        """Buffers shaped like the chunk's staged inputs, R_max rows deep
        (the candidate ids and the page are taken whole)."""
        dev = self.device
        inputs = {}
        for name, a in staged.items():
            shape = tuple(a.shape) if _whole(name) else (self.r_max, *a.shape[1:])
            dtype = torch.int64 if name == "batch_idx" else a.dtype
            inputs[name] = torch.zeros(shape, dtype=dtype, device=dev)
        p, s = self.p, staged["step_valid"].shape[2]
        r = self.r_max
        outs = {
            "ids": torch.zeros((r, p), dtype=torch.int64, device=dev),
            "exploited": torch.zeros((r,), dtype=torch.bool, device=dev),
            "stop": torch.zeros((r,), dtype=torch.bool, device=dev),
            "acc": torch.zeros((r,), dtype=torch.float32, device=dev),
            "evaluated": torch.zeros((r,), dtype=torch.bool, device=dev),
            "losses": torch.zeros((r, p, s), dtype=torch.float32, device=dev),
            "step_valid": torch.zeros((r, p, s), dtype=torch.float32, device=dev),
            "valid": torch.zeros((r,), dtype=torch.bool, device=dev),
        }
        if self.async_plan is not None:
            outs["tau_hist"] = torch.zeros((r, self.async_plan.depth), dtype=torch.int32,
                                           device=dev)
        return _Program(inputs, outs, torch.zeros((1,), dtype=torch.int64, device=dev))

    def live_bytes(self) -> int:
        tensors = [self.w, *self.program.carry.values(), *self.ring.values()]
        if self.store is not None:
            tensors += [self.store.x, self.store.y, self.store.sizes]
        for prog in self.programs.values():
            tensors += [*prog.inputs.values(), *prog.outs.values()]
        return sum(t.numel() * t.element_size() for t in tensors)

    # -- the round body ----------------------------------------------------------
    def _body(self, prog: _Program, key: tuple) -> None:
        """One round at the device counter's row of the chunk's inputs."""
        use_prox, has_mask, _, _ = key
        inp, outs, counter = prog.inputs, prog.outs, prog.counter
        program, model, p = self.program, self.model, self.p

        def row(name):
            return inp[name].index_select(0, counter).squeeze(0)

        def put(name, value):
            outs[name].index_copy_(0, counter, value.unsqueeze(0))

        live = torch.logical_not(self.stopped)
        t = row("t")
        w = self.w
        cand = inp["cand"]
        if program.select is not None:
            slots, exploited = program.select(program.carry, row("explore"),
                                              row("explore_slots"), cand)
        else:
            slots = row("host_slots")
            exploited = torch.zeros((), dtype=torch.bool, device=w.device)
        ids = cand[slots]
        if "page_x" in inp:                  # a page's rows are slots
            store = DeviceClientStore(inp["page_x"], inp["page_y"], inp["page_sizes"], cand)
            rows = slots
        else:
            store, rows = self.store, ids
        sizes = store.sizes[rows]
        bi = row("batch_idx")[slots]                     # (P, S, B)

        def batch_at(s):
            return store.gather_step(rows, bi[:, s])

        mask = ({k: row("mask." + k) for k in self.unflatten(w)} if has_mask else None)
        step_valid = row("step_valid")[slots]
        flat, losses = self.trainer.run_steps(
            self.unflatten(w), step_valid.shape[1], batch_at, row("sample_w")[slots],
            step_valid, mask, row("freeze"), row("prox")[slots], use_prox)
        if self.transform is not None:
            flat = self.transform(t, ids, flat)
        if self.async_plan is not None:
            w_new, stop = self._async_round(t, w, ids, sizes, flat, exploited, live, put)
        else:
            # Eq. 4: n_k / Σn in float64, then float32, as the loop's host weights
            total = sizes.sum()
            weights = torch.where(total > 0, sizes / total,
                                  torch.full_like(sizes, 1.0 / p)).float()
            w_new = kops.weighted_aggregate(w, flat, weights)
            if program.post_round is not None:
                stop = program.post_round(program.carry, t, w, ids, flat, exploited, live)
            else:
                stop = torch.zeros((), dtype=torch.bool, device=w.device)
        evaluated = (t % self.eval_every == 0) | stop | (t == self.max_rounds - 1)
        acc = model.accuracy(self.unflatten(w_new), self.eval_x, self.eval_y).float()
        acc = torch.where(evaluated, acc, self.last_acc)
        for name, value in (("ids", ids), ("exploited", exploited), ("stop", stop),
                            ("acc", acc), ("evaluated", evaluated), ("losses", losses),
                            ("step_valid", step_valid), ("valid", live)):
            put(name, value)
        w.copy_(torch.where(live, w_new, w))
        self.last_acc.copy_(torch.where(live, acc, self.last_acc))
        self.stopped.copy_(torch.logical_or(self.stopped, stop))
        counter.add_(1)

    def _async_round(self, t, w, ids, sizes, flat, exploited, live, put):
        """The async round after training: park the departing cohort in slot
        ``t mod B``, aggregate what lands at ``t`` by the staleness-weighted
        Eq. 4, hand the arrivals to ``post_round_async``, drop them from the
        ring and write the arrival histogram.  Every ring write is masked by
        ``live``.  Returns ``(w_new, stop)``."""
        plan, ring, program, p = self.async_plan, self.ring, self.program, self.p
        b = plan.depth
        slot = torch.remainder(t, b).reshape(1)
        t32 = t.to(torch.int32)
        for name, value in (("u", flat), ("sizes", sizes), ("ids", ids),
                            ("depart", t32.expand(p)), ("land", t32 + plan.delays(t, ids)),
                            ("valid", torch.ones_like(ring["valid"][0])), ("anchor", w)):
            buf = ring[name]
            old = buf.index_select(0, slot).squeeze(0)
            buf.index_copy_(0, slot, torch.where(live, value, old).unsqueeze(0))
        buf_u = ring["u"].view(b * p, -1)
        buf_ids, buf_depart = ring["ids"].view(-1), ring["depart"].view(-1)
        buf_valid = ring["valid"].view(-1)
        arrived = buf_valid & (ring["land"].view(-1) == t32)
        tau = staleness_of(buf_depart, t32).clamp(0, plan.max_staleness)
        # Eq. 4 over the arrivals, n_k·decay(τ_k) in float64 then float32 as
        # the synchronous weights (decay(0) = 1.0 changes no bit); a round
        # with no arrival has all-zero weights and leaves w as it was
        scaled = torch.where(arrived, ring["sizes"].view(-1) * plan.decay_table[tau.long()], 0.0)
        total = scaled.sum()
        n_arr = arrived.sum().to(scaled.dtype)
        weights = torch.where(total > 0, scaled / total,
                              torch.where(arrived, 1.0 / n_arr.clamp_min(1.0), 0.0)).float()
        w_new = kops.weighted_aggregate(w, buf_u, weights)
        if program.post_round_async is not None:
            stop = program.post_round_async(
                program.carry, t, w, buf_ids, buf_depart, buf_u,
                ring["anchor"][:, None].expand(b, p, -1).reshape(b * p, -1), arrived, exploited,
                live)
        else:
            stop = torch.zeros((), dtype=torch.bool, device=w.device)
        ring["valid"].copy_(torch.where(live, (buf_valid & ~arrived).view(b, p), ring["valid"]))
        put("tau_hist", ((tau[None, :] == self.taus[:, None]) & arrived[None, :]).sum(1)
            .to(torch.int32))
        return w_new, stop

    def _capture(self, prog: _Program, key: tuple) -> None:
        """Warm the body up once with the job marked stopped, a round that
        leaves the carry bitwise as it was, then capture it on the compute
        stream.  The arrival counters the ``gram`` kernel uses on this
        stream exist before the capture and live as long as the graph."""
        from repro_torch.kernels.grid import arrival_counters

        t0 = time.perf_counter()
        with _no_hidden_sync(True), torch.cuda.stream(self.stream):
            arrival_counters(self.device, self.stream, 1)
            stopped = self.stopped.clone()
            self.stopped.fill_(True)
            self._body(prog, key)
            self.stopped.copy_(stopped)
            prog.counter.zero_()
        self.stream.synchronize()
        warm = kops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            self._body(prog, key)
        after = kops.launch_counts()
        prog.captured_launches = {k: after[k] - warm[k] for k in after}
        prog.graph = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    # -- one chunk ---------------------------------------------------------------
    def dispatch(self, plan: "_ChunkPlan") -> Dict[str, torch.Tensor]:
        """Enqueue the chunk: input copies, R rounds (graph replays on the
        card), the copy of the outputs to the host.  Returns the host
        outputs, filled once ``plan.done`` has fired."""
        cuda = self.stream is not None
        ctx = torch.cuda.stream(self.stream) if cuda else contextlib.nullcontext()
        with ctx:
            prog = self.programs.get(plan.key)
            new = prog is None
            if new:
                prog = self.programs[plan.key] = self._new_program(plan.staged)
        with _no_hidden_sync(cuda), ctx:
            if plan.ready is not None:
                self.stream.wait_event(plan.ready)
            for name, src in plan.staged.items():
                dst = prog.inputs[name]
                (dst if _whole(name) else dst[:plan.r]).copy_(src, non_blocking=True)
            prog.counter.zero_()
        if new and self.capture:
            self._capture(prog, plan.key)
        with _no_hidden_sync(cuda), ctx:
            for _ in range(plan.r):
                if prog.graph is not None:
                    prog.graph.replay()
                else:
                    self._body(prog, plan.key)
            prog.replays += plan.r
            if not cuda:
                return {k: v[:plan.r].clone() for k, v in prog.outs.items()}
            host = {k: torch.empty(v[:plan.r].shape, dtype=v.dtype, pin_memory=True)
                    for k, v in prog.outs.items()}
            for k, v in prog.outs.items():
                host[k].copy_(v[:plan.r], non_blocking=True)
            plan.done = torch.cuda.Event()
            plan.done.record(self.stream)
        return host

    def settle(self) -> None:
        """Make the caller's stream wait for every chunk dispatched so far,
        before the host reads the carry."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


@dataclasses.dataclass
class _ChunkPlan:
    """One chunk's host-built inputs, ready for (or already in) flight."""

    t0: int
    r: int
    cand: np.ndarray              # (n_cand,) sorted global candidate ids (real)
    cfg_grid: List[List[Any]]     # (R, P_cand) LocalConfigs — reused at flush
    steps: np.ndarray             # (R, P_cand) real local steps per candidate
    key: tuple                    # (use_prox, has_mask, S, P_cand)
    staged: Dict[str, torch.Tensor]
    ready: Optional[Any]          # event: the staged copies are on the device
    sched_bytes: int
    page_bytes: int
    done: Optional[Any] = None    # event: the chunk's outputs are on the host


def run_scan_driver(
    model,
    dataset: FederatedDataset,
    strategy: TorchStrategy,
    *,
    max_rounds: int,
    learning_rate: float,
    batch_size: int,
    device: str,
    eval_every: int,
    seed: int,
    init_params: Optional[Params],
    verbose: bool,
    chunk_rounds: int,
    torch_device: torch.device,
    pipeline: bool = True,
    paged: bool = False,
    capture: Optional[bool] = None,
    async_rounds: Optional[AsyncConfig] = None,
):
    """Algorithm 4's outer loop in chunks of ``chunk_rounds`` rounds; called
    by ``run_federated(driver="scan")``, returns its :class:`FLResult`.

    ``async_rounds`` runs staleness-aware rounds (see the module docstring):
    it needs the resident store and, from a strategy with ``post_round``,
    ``post_round_async``.

    ``capture`` (default: on CUDA) replays each chunk from a CUDA graph;
    ``capture=False`` runs the same body eagerly on the card, which is what
    the graph is held against.
    """
    from repro_torch.fl.rounds import RoundRecord, finalize_result, initial_params, nan_safe_mean

    if chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    if paged and not strategy.supports_paged_store:
        raise ValueError(f"{strategy.name} does not support client_store='paged' "
                         "(supports_paged_store is False)")
    dev = torch_device
    cuda = dev.type == "cuda"
    if capture is None:
        capture = cuda
    if capture and not cuda:
        raise ValueError("capture=True needs the chunks on a CUDA device")
    params = initial_params(model, init_params, seed, dev)
    n_params = param_count(params)
    strategy.bind_device(dev)
    program = strategy.scan_program()
    if program.post_round is not None and program.select is None:
        raise ValueError("a ScanProgram with post_round needs device select: a host-selected "
                         "chunk cannot react to a device stop mid-chunk")
    if program.select is not None and program.draws is None:
        raise ValueError("a ScanProgram with device select must provide draws")
    if async_rounds is not None:
        if paged:
            raise ValueError("async_rounds requires client_store='resident': the paged store's "
                             "per-chunk pages cannot hold cohorts that land in a later chunk")
        if program.post_round is not None and program.post_round_async is None:
            raise ValueError(
                f"{strategy.name}'s ScanProgram has per-round bookkeeping (post_round) but no "
                "post_round_async: async rounds would feed stale arrivals to the synchronous "
                "hook (FLrce withholds the async hook under sketched V/A maps)")
    w, unflatten = flatten_params(params)
    if paged:
        host_store, store = HostClientStore.from_dataset(dataset), None
        sizes_host = host_store.sizes_host
    else:
        host_store, store = None, DeviceClientStore.from_dataset(dataset, dev)
        sizes_host = store.sizes_host
    m = len(sizes_host)
    ledger = ResourceLedger(device=device)
    transform = strategy.update_transform(params)
    async_plan = None if async_rounds is None else resolve_async_plan(
        async_rounds, num_clients=m, seed=seed, device=dev)
    runner = _ChunkRunner(
        model, BatchedCohortTrainer(model, learning_rate, batch_size, dev), w, unflatten,
        program, transform, store, clients_per_round=strategy.p, eval_every=eval_every,
        max_rounds=max_rounds, chunk_rounds=chunk_rounds,
        eval_x=torch.from_numpy(dataset.eval_x).to(dev),
        eval_y=torch.from_numpy(dataset.eval_y).to(dev), capture=capture,
        async_plan=async_plan)
    stager = PinnedStager(dev, consumer=runner.stream)
    # host selection materialises masks from a CPU template of the params
    template = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in params.items()}
    n_leaves = len(params)

    def build_chunk(t0: int) -> _ChunkPlan:
        """Everything a chunk needs before dispatch, a pure function of
        ``(strategy, seed, t0)``: candidates, configs, schedules, variants,
        the staged copies (page included)."""
        r = min(chunk_rounds, max_rounds - t0)
        ts = list(range(t0, t0 + r))
        if program.select is None:
            host_ids = np.stack([np.asarray(strategy.select(t)) for t in ts]).astype(np.int64)
            cand = np.unique(host_ids)
            n_bucket = _bucket_candidates(len(cand), m)
            cand_pad = np.concatenate([cand, np.full(n_bucket - len(cand), cand[-1], np.int64)])
            host_slots = np.searchsorted(cand, host_ids)
            explore = np.zeros(r, bool)
            explore_slots = np.zeros((r, strategy.p), np.int64)
        else:
            host_ids = None
            proposal = strategy.propose_candidates(np.asarray(ts))
            if proposal is None:
                cand = np.arange(m, dtype=np.int64)
            else:
                cand = np.asarray(proposal, np.int64)
                if (cand.ndim != 1 or len(cand) < strategy.p or len(np.unique(cand)) != len(cand)
                        or np.any(np.diff(cand) < 0)
                        or (len(cand) and (cand[0] < 0 or cand[-1] >= m))):
                    raise ValueError(
                        f"{strategy.name}.propose_candidates must return sorted unique ids in "
                        f"[0, {m}) with P_cand >= P={strategy.p}; got shape {cand.shape}")
            cand_pad = cand
            host_slots = np.zeros((r, strategy.p), np.int64)
            explore, explore_slots = program.draws(ts, len(cand))
        cfg_grid = [[strategy.client_config(t, int(cid), None) for cid in cand_pad] for t in ts]
        if any(cfg.mask is not None for row in cfg_grid for cfg in row):
            raise ValueError(f"{strategy.name} materialized a mask from client_config(t, cid, "
                             "None); with a None template the config must be metadata-only")
        epochs = np.asarray([[cfg.epochs for cfg in row] for row in cfg_grid], np.int32)
        prox = np.asarray([[cfg.prox_mu for cfg in row] for row in cfg_grid], np.float32)
        use_prox = bool(np.any(prox > 0.0))
        if program.select is not None and (
                any(cfg.freeze_frac for row in cfg_grid for cfg in row)
                or any(strategy.client_config(t, int(c), template).mask is not None
                       for t in ts for c in cand)):
            raise ValueError(f"{strategy.name} uses per-client masks or freeze flags; with "
                             "device-side selection they cannot be precomputed for the "
                             "selected cohort (host-precomputable selection is required)")
        sched = build_chunk_schedule(
            sizes_host[cand_pad], epochs, batch_size, t0,
            lambda t, cid: client_batch_rng(seed, t, cid), cache_key=seed, client_ids=cand_pad)
        stager.begin()
        place_schedule(sched, stager)
        for name, a in (("t", np.asarray(ts, np.int64)), ("explore", explore),
                        ("explore_slots", explore_slots), ("host_slots", host_slots),
                        ("prox", prox), ("cand", cand_pad.astype(np.int64))):
            np.copyto(stager.buffer(name, a.shape, a.dtype), a)
        freeze = stager.buffer("freeze", (r, n_leaves, strategy.p), np.float32)
        has_mask = False
        if host_ids is None:
            freeze[...] = 1.0
        else:
            sel_cfgs = [[strategy.client_config(t, int(c), template) for c in host_ids[i]]
                        for i, t in enumerate(ts)]
            for i, row in enumerate(sel_cfgs):
                freeze[i] = np.stack([freeze_flags(n_leaves, c.freeze_frac) for c in row], axis=1)
            has_mask = any(c.mask is not None for row in sel_cfgs for c in row)
            if has_mask:
                for k, leaf in template.items():
                    buf = stager.buffer("mask." + k, (r, strategy.p, *leaf.shape), np.float32)
                    for i, row in enumerate(sel_cfgs):
                        for j, c in enumerate(row):
                            buf[i, j] = 1.0 if c.mask is None else c.mask[k].numpy()
        page_bytes = host_store.page(cand_pad, stager) if paged else 0
        staged, ready = stager.send()
        return _ChunkPlan(
            t0=t0, r=r, cand=cand, cfg_grid=cfg_grid,
            steps=sched.step_valid.sum(axis=2).astype(np.int64),
            key=(use_prox, has_mask, sched.num_steps, len(cand_pad)),
            staged=staged, ready=ready, sched_bytes=int(sched.nbytes), page_bytes=page_bytes)

    records: List[RoundRecord] = []
    stats: Dict[str, Any] = {
        "driver": "scan", "pipeline": bool(pipeline), "store": "paged" if paged else "resident",
        "chunks": 0, "speculative_chunks": 0, "cancelled_chunks": 0,
        "host_build_s": 0.0, "device_wait_s": 0.0, "host_flush_s": 0.0, "total_s": 0.0,
        "schedule_bytes_host": 0, "page_bytes_h2d": 0, "peak_live_bytes": 0,
        "captures_chunk": 0, "captures_total": 0, "programs": 0, "host_syncs": 0,
        "replays": 0, "replay_launches": {}, "steps": [],
    }
    if async_plan is not None:
        stats["async_max_staleness"] = async_plan.max_staleness
        stats["async_arrivals"] = 0

    def flush_chunk(plan: _ChunkPlan, outs) -> Tuple[int, bool]:
        """Ledger and records of one chunk's host outputs:
        ``(rounds flushed, chunk stopped)``."""
        flushed, chunk_stopped = 0, False
        for i in range(plan.r):
            if not outs["valid"][i]:
                break
            t = plan.t0 + i
            ids = [int(c) for c in outs["ids"][i]]
            slots = np.searchsorted(plan.cand, ids)
            for cid, slot in zip(ids, slots):
                cfg = plan.cfg_grid[i][int(slot)]
                flops = (model.flops_per_sample() * int(sizes_host[cid])
                         * cfg.epochs * cfg.compute_fraction)
                ledger.charge_training(flops)
                ledger.charge_download(n_params, cfg.download_fraction)
                ledger.charge_upload(n_params, cfg.upload_fraction)
            if "tau_hist" in outs:
                # charged above at departure; what lands now is only counted
                hist = outs["tau_hist"][i]
                ledger.record_arrivals(hist)
                stats["async_arrivals"] += int(hist.sum())
            ledger.end_round()
            means = mean_losses(outs["losses"][i], outs["step_valid"][i])
            rec = RoundRecord(
                t=t, accuracy=float(outs["acc"][i]), mean_client_loss=nan_safe_mean(means),
                energy_kj=ledger.energy_j / 1e3, bytes_gb=ledger.total_bytes / 1e9,
                selected=ids, exploited=bool(outs["exploited"][i]),
                stopped=bool(outs["stop"][i]), wall_s=0.0,
                evaluated=bool(outs["evaluated"][i]))
            records.append(rec)
            stats["steps"].append((int(plan.steps[i, slots].max()), int(plan.key[2])))
            flushed += 1
            if verbose:
                print(f"[{strategy.name}] round {t:3d} acc={rec.accuracy:.4f} "
                      f"loss={rec.mean_client_loss:.4f} stop={rec.stopped}")
            if rec.stopped:
                chunk_stopped = True
                break
        return flushed, chunk_stopped

    # the chunk loop: a software pipeline of depth 1 (serial) or 2
    depth = 2 if pipeline else 1
    pending: "deque[Tuple[_ChunkPlan, Any]]" = deque()
    stopped = any_flushed = last_exploit = False
    t_final = t_dispatch = 0
    t_start = time.perf_counter()
    flush_mark = t_start
    while pending or (t_dispatch < max_rounds and not stopped):
        while len(pending) < depth and t_dispatch < max_rounds and not stopped:
            b0 = time.perf_counter()
            plan = build_chunk(t_dispatch)
            outs = runner.dispatch(plan)
            stats["host_build_s"] += time.perf_counter() - b0
            stats["schedule_bytes_host"] += plan.sched_bytes
            stats["page_bytes_h2d"] += plan.page_bytes
            if pending:
                stats["speculative_chunks"] += 1
            pending.append((plan, outs))
            t_dispatch += plan.r

        plan, outs = pending.popleft()
        w0 = time.perf_counter()
        if plan.done is not None:
            plan.done.synchronize()              # the chunk's one host sync
            stats["host_syncs"] += 1
        stats["device_wait_s"] += time.perf_counter() - w0
        live = (torch.cuda.memory_allocated(dev) if cuda
                else runner.live_bytes() + sum(t.numel() * t.element_size()
                                               for p_, _ in pending for t in p_.staged.values()))
        stats["peak_live_bytes"] = max(stats["peak_live_bytes"], live)
        f0 = time.perf_counter()
        flushed, chunk_stopped = flush_chunk(plan, {k: v.numpy() for k, v in outs.items()})
        if flushed:
            any_flushed = True
            last_exploit = bool(outs["exploited"][flushed - 1])
            t_final = plan.t0 + flushed
        now = time.perf_counter()
        wall, flush_mark = now - flush_mark, now
        for rec in records[-flushed:] if flushed else []:
            rec.wall_s = wall / flushed
        if chunk_stopped:
            # a chunk dispatched after the stop runs masked: drop it unread
            stopped = True
            stats["cancelled_chunks"] += len(pending)
            pending.clear()
        stats["chunks"] += 1
        stats["host_flush_s"] += time.perf_counter() - f0
        if not pending and any_flushed and program.finalize is not None:
            runner.settle()
            program.finalize(program.carry, t_final, last_exploit)

    runner.settle()
    if async_plan is not None:
        # departed and charged, never landed
        stats["async_pending_at_exit"] = int(runner.ring["valid"].sum())
    stats["total_s"] = time.perf_counter() - t_start
    stats["captures_chunk"] = stats["captures_total"] = runner.captures
    stats["capture_s"] = runner.capture_s
    stats["programs"] = len(runner.programs)
    stats["replays"] = sum(p_.replays for p_ in runner.programs.values())
    # kernel launches inside the replays, and in the warm-up round before
    # each capture (a launch's count is taken where its wrapper ran)
    stats["replay_launches"] = {
        k: sum(p_.replays * p_.captured_launches.get(k, 0) for p_ in runner.programs.values())
        for k in kops.KERNELS}
    stats["warmup_launches"] = {
        k: sum(p_.captured_launches.get(k, 0) for p_ in runner.programs.values())
        for k in kops.KERNELS}
    stats["h2d_bytes"] = stager.bytes_sent
    stats["store_bytes_device"] = 0 if paged else store.nbytes
    stats["store_bytes_host"] = host_store.nbytes if paged else 0
    return finalize_result(strategy=strategy, records=records, stopped=stopped, ledger=ledger,
                           final_params={k: v.clone() for k, v in unflatten(runner.w).items()},
                           driver_stats=stats)
