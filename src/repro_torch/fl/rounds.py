"""The federated round loop (paper Algorithm 4's outer loop).

Runs T rounds of: select → local training of the cohort (with the
strategy's prox/mask/freeze variants) → the strategy's update transform on
the device (Fedcom's top-k mask, QuantizedFL's int8 rounding) → Eq. 4
aggregation through the ``weighted_aggregate`` kernel → strategy bookkeeping
(FLrce's relationship ingest and Alg. 3 early stopping) → evaluation every
``eval_every`` rounds, with exact resource accounting through a
:class:`ResourceLedger`.

Two engines train the cohort: ``"batched"`` (the default, all clients in one
vmapped step) and ``"sequential"`` (the per-client oracle,
:class:`ClientTrainer`), whose updates are stacked into the same (P, D)
matrix.  The round's flat (D,) model and (P, D) update matrix stay on the
device and are shared by aggregation, ingest and early stopping.
``device=`` names the ledger's energy profile; the torch device is
``torch_device=`` and defaults to ``"cuda"``.

Two drivers run Algorithm 4's outer loop:

* ``driver="loop"`` (default): one Python iteration per round.
* ``driver="scan"``: chunks of ``scan_chunk_rounds`` rounds with one host
  sync each, replayed from a captured CUDA graph on the card
  (``fl/scan_driver.py``); ``pipeline`` (default on) overlaps the next
  chunk's build with the current one, ``client_store="paged"`` keeps the
  client universe in host memory and copies each chunk's candidate rows.
  It runs the batched engine and strategies with ``supports_scan``; the
  others (PyramidFL) fall back to the loop.  ``async_rounds=AsyncConfig(...)``
  runs its rounds staleness-aware (``fl/async_rounds.py``), for strategies
  with ``supports_async`` (FLrce with exact maps, FedAvg, Fedprox).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import flatten_params
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.aggregation import aggregation_weights
from repro_torch.fl.async_rounds import AsyncConfig
from repro_torch.fl.client import (
    BatchedCohortTrainer,
    ClientTrainer,
    build_cohort_plan,
    client_batch_rng,
)
from repro_torch.fl.metrics import ResourceLedger, communication_efficiency, computation_efficiency
from repro_torch.fl.strategy import LocalConfig, TorchStrategy
from repro_torch.kernels import ops as kops
from repro_torch.models.cnn import param_count

Params = Dict[str, torch.Tensor]

ENGINES = ("batched", "sequential")
DRIVERS = ("loop", "scan")


@dataclasses.dataclass
class RoundRecord:
    t: int
    accuracy: float
    mean_client_loss: float
    energy_kj: float
    bytes_gb: float
    selected: List[int]
    exploited: bool
    stopped: bool
    wall_s: float
    evaluated: bool = True   # False ⇒ ``accuracy`` is copied from the last
    # evaluated round (eval_every > 1), not a measurement of round t


@dataclasses.dataclass
class FLResult:
    strategy: str
    records: List[RoundRecord]
    final_accuracy: float
    rounds_run: int
    stopped_early: bool
    ledger: ResourceLedger
    final_params: Params
    # the scan driver's counters and timings (chunks, captures, syncs, the
    # build/wait/flush split, bytes); empty for the loop driver
    driver_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def energy_kj(self) -> float:
        return self.ledger.energy_j / 1e3

    @property
    def bytes_gb(self) -> float:
        return self.ledger.total_bytes / 1e9

    @property
    def computation_efficiency(self) -> float:
        return computation_efficiency(self.final_accuracy, self.ledger.energy_j)

    @property
    def communication_efficiency(self) -> float:
        return communication_efficiency(self.final_accuracy, self.ledger.total_bytes)

    def accuracy_curve(self) -> np.ndarray:
        return np.asarray([r.accuracy for r in self.records])

    def summary(self) -> Dict[str, float]:
        return {
            "strategy": self.strategy,
            "final_accuracy": self.final_accuracy,
            "rounds": self.rounds_run,
            "stopped_early": self.stopped_early,
            "energy_kj": self.energy_kj,
            "bytes_gb": self.bytes_gb,
            "comp_eff": self.computation_efficiency,
            "comm_eff": self.communication_efficiency,
        }


def nan_safe_mean(values: Sequence[float]) -> float:
    """Mean over the finite entries; NaN only when every entry is NaN."""
    vals = np.asarray(list(values), np.float64)
    finite = vals[~np.isnan(vals)]
    return float(finite.mean()) if finite.size else float("nan")


def finalize_result(
    *,
    strategy: TorchStrategy,
    records: List[RoundRecord],
    stopped: bool,
    ledger: ResourceLedger,
    final_params: Params,
    driver_stats: Optional[Dict[str, Any]] = None,
) -> FLResult:
    """Assemble the FLResult; the final accuracy is the last evaluated
    round's (the terminal round always is)."""
    final_accuracy = next((r.accuracy for r in reversed(records) if r.evaluated), 0.0)
    return FLResult(
        strategy=strategy.name,
        records=records,
        final_accuracy=final_accuracy,
        rounds_run=len(records),
        stopped_early=stopped,
        ledger=ledger,
        final_params=final_params,
        driver_stats=driver_stats or {},
    )


def check_param_subset(model, strategy: TorchStrategy) -> None:
    """Reject a param-subset model (LoRA adapters) under a strategy whose
    variants presume the full parameter vector."""
    if getattr(model, "param_subset", False) and not strategy.supports_param_subset:
        reason = strategy.param_subset_reason
        raise ValueError(
            f"{strategy.name} does not support param-subset models like "
            f"{getattr(model, 'name', type(model).__name__)} (supports_param_subset is False"
            + (f": {reason}" if reason else "") + ")")


def initial_params(model, init_params: Optional[Params], seed: int,
                   dev: torch.device) -> Params:
    """The job's trained dict at round 0, on ``dev``: ``init_params`` or
    ``model.init(seed)``.

    Every trained leaf must be fp32: the flat round buffer is fp32 and its
    inverse returns fp32 views, so a bf16 leaf would silently train in fp32,
    which the reference never does (its batched engine cannot carry a bf16
    full model at all).  A LoRA model's frozen base keeps its own dtype; its
    adapters are fp32."""
    params = model.init(seed, dev) if init_params is None else dict(init_params)
    odd = {k: v.dtype for k, v in params.items() if v.dtype != torch.float32}
    if odd:
        name, dtype = next(iter(odd.items()))
        raise ValueError(
            f"{getattr(model, 'name', type(model).__name__)}: trained leaves must be float32, "
            f"got {len(odd)} others ({name}: {dtype}); the round's flat buffer is float32, so "
            "a reduced-precision model would train in float32 silently.  Train a bf16 model "
            "through a param-subset wrapper such as LoRAClassifier, whose frozen base keeps "
            "its dtype")
    return {k: v.to(dev) for k, v in params.items()}


def _sequential_round(
    trainer: ClientTrainer,
    params: Params,
    dataset: FederatedDataset,
    ids: np.ndarray,
    cfgs: Sequence[LocalConfig],
    rngs: Sequence[np.random.Generator],
) -> Tuple[List[Params], List[Dict[str, float]]]:
    """The oracle's round: a Python loop over clients, each over its batches."""
    updates, stats = [], []
    for cid, cfg, rng_k in zip(ids, cfgs, rngs):
        x_k, y_k = dataset.client_data(int(cid))
        update, st = trainer.local_update(
            params, x_k, y_k, cfg.epochs, rng_k,
            prox_mu=cfg.prox_mu, mask=cfg.mask, freeze_frac=cfg.freeze_frac,
        )
        updates.append(update)
        stats.append(st)
    return updates, stats


def run_federated(
    model,
    dataset: FederatedDataset,
    strategy: TorchStrategy,
    *,
    max_rounds: int = 100,
    learning_rate: float = 0.05,
    batch_size: int = 32,
    device: str = "jetson_nano",
    eval_every: int = 1,
    seed: int = 0,
    init_params: Optional[Params] = None,
    verbose: bool = False,
    engine: str = "batched",
    mesh=None,
    driver: str = "loop",
    scan_chunk_rounds: int = 8,
    pipeline: Optional[bool] = None,
    client_store: str = "resident",
    async_rounds: Optional[AsyncConfig] = None,
    torch_device: DeviceLike = "cuda",
) -> FLResult:
    if engine == "sharded" or mesh is not None:
        raise ValueError(
            "engine='sharded' and mesh= are the reference's multi-device path; the port "
            "runs one device until ROADMAP A.8 (multi-GPU) lands")
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if driver not in DRIVERS:
        raise ValueError(f"driver must be one of {DRIVERS}, got {driver!r}")
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if pipeline is not None and driver != "scan":
        raise ValueError(
            "pipeline= selects the scan driver's chunk pipelining; it has no "
            f"meaning for driver={driver!r} (pass driver='scan')")
    if client_store not in ("resident", "paged"):
        raise ValueError(f"client_store must be 'resident' or 'paged', got {client_store!r}")
    if client_store == "paged" and driver != "scan":
        raise ValueError(
            "client_store='paged' is the scan driver's host-paged store; it "
            f"has no meaning for driver={driver!r} (pass driver='scan')")
    check_param_subset(model, strategy)
    if async_rounds is not None:
        if not isinstance(async_rounds, AsyncConfig):
            raise ValueError(
                f"async_rounds must be an AsyncConfig, got {type(async_rounds).__name__}")
        async_rounds.validate(len(dataset.client_indices))
        if driver != "scan":
            raise ValueError(
                "async_rounds runs staleness-aware rounds on the compiled chunk driver; it has "
                f"no meaning for driver={driver!r} (pass driver='scan')")
        if not strategy.supports_async:
            raise ValueError(
                f"{strategy.name} does not support async_rounds (supports_async is False)")
    dev = resolve_device(torch_device)
    if driver == "scan":
        if engine == "sequential":
            raise ValueError(
                "driver='scan' runs the batched engine; engine='sequential' is the "
                f"per-step reference loop (got engine={engine!r}, use 'batched')")
        if strategy.supports_scan:
            from repro_torch.fl.scan_driver import run_scan_driver

            return run_scan_driver(
                model, dataset, strategy, max_rounds=max_rounds, learning_rate=learning_rate,
                batch_size=batch_size, device=device, eval_every=eval_every, seed=seed,
                init_params=init_params, verbose=verbose, chunk_rounds=scan_chunk_rounds,
                torch_device=dev, pipeline=True if pipeline is None else pipeline,
                paged=client_store == "paged", async_rounds=async_rounds)
        if async_rounds is not None:
            # the loop has no pending cohorts: running it would fake the experiment
            raise ValueError(
                f"async_rounds requires the compiled scan path, but {strategy.name} falls back "
                f"to the {engine} loop driver (supports_scan)")
        if client_store == "paged":
            raise ValueError(
                f"client_store='paged' requires the compiled scan path, but {strategy.name} "
                f"falls back to the {engine} loop driver (supports_scan)")
        if verbose:
            print(f"[{strategy.name}] no scan support for engine={engine!r}; "
                  f"falling back to the {engine} loop driver")
    params = initial_params(model, init_params, seed, dev)
    n_params = param_count(params)
    strategy.bind_device(dev)
    # the strategy's update post-processing stage, built once per job
    transform = strategy.update_transform(params)
    if engine == "sequential":
        trainer = ClientTrainer(model, learning_rate, batch_size, dev)
    else:
        trainer = BatchedCohortTrainer(model, learning_rate, batch_size, dev)
    ledger = ResourceLedger(device=device)
    eval_x = torch.from_numpy(dataset.eval_x).to(dev)
    eval_y = torch.from_numpy(dataset.eval_y).to(dev)
    sizes = dataset.client_sizes()
    records: List[RoundRecord] = []
    stopped = False
    last_eval_acc = 0.0

    for t in range(max_rounds):
        t0 = time.perf_counter()
        ids = strategy.select(t)
        # the round's flat buffer: flattened once, shared by aggregation,
        # relationship modeling and early stopping
        w_before, unflatten = flatten_params(params)
        cfgs = [strategy.client_config(t, int(cid), params) for cid in ids]
        rngs = [client_batch_rng(seed, t, int(cid)) for cid in ids]
        if engine == "sequential":
            updates, stats = _sequential_round(trainer, params, dataset, ids, cfgs, rngs)
            update_matrix = torch.stack([flatten_params(u)[0] for u in updates])
        else:
            plan = build_cohort_plan(
                [dataset.client_data(int(cid)) for cid in ids],
                [cfg.epochs for cfg in cfgs],
                batch_size,
                rngs,
            )
            update_matrix, stats = trainer.train_cohort(
                params,
                plan,
                prox_mus=[cfg.prox_mu for cfg in cfgs],
                masks=[cfg.mask for cfg in cfgs],
                freeze_fracs=[cfg.freeze_frac for cfg in cfgs],
            )
        if transform is not None:
            update_matrix = transform(t, np.asarray(ids), update_matrix)

        # resource accounting: host float64 arithmetic, as in the reference
        for cid, cfg in zip(ids, cfgs):
            flops = (
                model.flops_per_sample() * int(sizes[int(cid)]) * cfg.epochs * cfg.compute_fraction
            )
            ledger.charge_training(flops)
            ledger.charge_download(n_params, cfg.download_fraction)
            ledger.charge_upload(n_params, cfg.upload_fraction)

        # Eq. 4 aggregation (weights float64 → float32 on the host)
        weights = torch.from_numpy(
            np.asarray(aggregation_weights(sizes[ids]), np.float32)
        ).to(dev)
        params = unflatten(kops.weighted_aggregate(w_before, update_matrix, weights))

        stop = strategy.post_round(t, w_before, ids, update_matrix, stats)
        ledger.end_round()

        evaluated = (t % eval_every == 0) or stop or (t == max_rounds - 1)
        if evaluated:
            with torch.no_grad():
                acc = float(model.accuracy(params, eval_x, eval_y))
            last_eval_acc = acc
        else:
            acc = last_eval_acc
        rec = RoundRecord(
            t=t,
            accuracy=acc,
            mean_client_loss=nan_safe_mean([s["mean_loss"] for s in stats]),
            energy_kj=ledger.energy_j / 1e3,
            bytes_gb=ledger.total_bytes / 1e9,
            selected=[int(c) for c in ids],
            exploited=strategy.last_round_was_exploit,
            stopped=bool(stop),
            wall_s=time.perf_counter() - t0,
            evaluated=evaluated,
        )
        records.append(rec)
        if verbose:
            print(
                f"[{strategy.name}] round {t:3d} acc={acc:.4f} "
                f"loss={rec.mean_client_loss:.4f} stop={stop} wall={rec.wall_s:.3f}s"
            )
        if stop:
            stopped = True
            break

    return finalize_result(
        strategy=strategy, records=records, stopped=stopped, ledger=ledger, final_params=params,
    )
