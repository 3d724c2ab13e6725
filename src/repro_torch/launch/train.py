"""Federated training driver of the port, from the reference's
``src/repro/launch/train.py``.

Two modes:

* ``--mode paper``    — the paper's configuration: M clients x P per round x
  T rounds of FLrce (or a baseline) on a synthetic Dirichlet-non-iid
  classification federation.
* ``--mode pretrain`` — cross-silo federated pretraining of an architecture
  (reduced unless ``--full-config``): each silo runs local LM steps on its
  Zipf-Markov token stream; the server applies FLrce's relationship-based
  selection and early stopping over the silo deltas, which are the full
  model's.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --mode paper --strategy flrce
    PYTHONPATH=src python -m repro_torch.launch.train --mode pretrain --arch deepseek-7b \\
        --silos 8 --rounds 20

Runs on CUDA unless ``--device cpu`` is given.  Pretrain mode draws the model
from ``--seed`` with ``TransformerLM.init``, the reference's weights for that
seed; a bf16 model trains in bf16, each round's flat fp32
mean cast back to every leaf's dtype, as the reference's ``flatten_pytree``
inverse does.  ``--arch`` offers every architecture the port serves.  A
local step takes ``TransformerLM.loss`` of its batch, as the reference's
does: a mixture-of-experts model (mixtral-8x22b, dbrx-132b) routes the
batch's tokens together and adds the batch's load-balance loss, which is
the sequential engine's function, not the batched engine's per-sequence
one (``models/lm.py``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.distributed import flatten_params
from repro_torch.core.server import FLrceServer
from repro_torch.data import SiloTokenStream, make_federated_classification
from repro_torch.device import resolve_device
from repro_torch.fl import FLrce, run_federated
from repro_torch.fl.aggregation import aggregation_weights
from repro_torch.fl.baselines import Dropout, FedAvg, Fedcom, Fedprox, PyramidFL, TimelyFL
from repro_torch.kernels import ops as kops
from repro_torch.launch.steps import build_train_step
from repro_torch.models import MLPClassifier, TransformerLM, param_count
from repro_torch.models.lm import flat_from_lm, lm_from_flat
from repro_torch.optim import sgd

STRATS = {
    "flrce": FLrce, "fedavg": FedAvg, "fedcom": Fedcom, "fedprox": Fedprox,
    "dropout": Dropout, "pyramidfl": PyramidFL, "timelyfl": TimelyFL,
}


def run_paper_mode(args) -> dict:
    dev = resolve_device(args.device)
    ds = make_federated_classification(
        num_clients=args.clients, alpha=args.alpha, num_samples=args.samples,
        num_eval=max(200, args.samples // 10), feature_dim=24, num_classes=10,
        noise=0.8, seed=args.seed,
    )
    model = MLPClassifier(feature_dim=24, num_classes=10, hidden=(48, 32))
    dim = param_count(model.init(0, "cpu"))
    if args.strategy == "flrce":
        strat = FLrce(args.clients, args.participants, args.epochs, dim=dim,
                      es_threshold=args.psi or args.participants / 2, seed=args.seed)
    else:
        strat = STRATS[args.strategy](args.clients, args.participants, args.epochs,
                                      seed=args.seed)
    res = run_federated(model, ds, strat, max_rounds=args.rounds, learning_rate=0.08,
                        batch_size=32, seed=args.seed, verbose=True, torch_device=dev)
    print(json.dumps(res.summary(), indent=1, default=float))
    return res.summary()


def run_pretrain_mode(args, params: Optional[Dict[str, Any]] = None) -> dict:
    """Cross-silo federated LM pretraining with FLrce server-side control.

    ``params`` (``TransformerLM`` parameters on the device) replaces the
    random draw, so a caller can start from given weights."""
    cfg = get_arch(args.arch, reduced=not args.full_config)
    dev = resolve_device(args.device)
    model = TransformerLM(cfg, remat=True)
    if params is None:
        params = model.init(args.seed, dev)
    flat = flat_from_lm(cfg, params)
    dtypes = {k: v.dtype for k, v in flat.items()}
    dim = param_count(flat)
    print(f"[pretrain] {cfg.name}: {dim:,} params, {args.silos} silos")
    stream = SiloTokenStream(cfg.vocab_size, args.silos, seed=args.seed)
    server = FLrceServer(args.silos, dim, args.participants,
                         es_threshold=args.psi or args.participants / 2, seed=args.seed,
                         device=dev)
    optimizer = sgd(args.lr)
    local_step = build_train_step(model, optimizer)

    def flat_of(p) -> torch.Tensor:
        return flatten_params(flat_from_lm(cfg, p))[0]

    history = []
    for t in range(args.rounds):
        t0 = time.perf_counter()
        ids = server.select()
        w_before, unflatten = flatten_params(flat)
        updates, losses = [], []
        for silo in ids:
            local = lm_from_flat(cfg, flat)
            opt_state = optimizer.init(local)
            for step in range(args.local_steps):
                toks = torch.from_numpy(
                    stream.batch(int(silo), args.batch, args.seq, step=t * 100 + step)).to(dev)
                batch = {"tokens": toks[:, :-1].long(), "labels": toks[:, 1:].long()}
                local, opt_state, metrics = local_step(local, opt_state, batch)
            losses.append(float(metrics["loss"]))
            updates.append(flat_of(local) - w_before)
        upd_mat = torch.stack(updates)
        weights = torch.from_numpy(
            np.asarray(aggregation_weights([1.0] * len(ids)), np.float32)).to(dev)
        # the fp32 mean, cast back to each leaf's dtype
        flat = {k: v.to(dtypes[k])
                for k, v in unflatten(kops.weighted_aggregate(w_before, upd_mat, weights)).items()}
        server.ingest(w_before, ids, upd_mat)
        stop = server.check_early_stop(upd_mat)
        server.advance_round()
        rec = {"round": t, "silos": [int(i) for i in ids],
               "mean_loss": float(np.mean(losses)),
               "conflicts": float(server.state.last_conflicts),
               "exploit": server.last_round_was_exploit,
               "stopped": bool(stop), "wall_s": round(time.perf_counter() - t0, 2)}
        history.append(rec)
        print(f"[pretrain] {json.dumps(rec)}")
        if stop:
            print(f"[pretrain] FLrce early stopping at round {t} "
                  f"(conflicts={server.state.last_conflicts:.2f})")
            break
    return {"rounds": len(history), "final_loss": history[-1]["mean_loss"],
            "stopped_early": history[-1]["stopped"], "history": history}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=["paper", "pretrain"], default="paper")
    ap.add_argument("--strategy", choices=sorted(STRATS), default="flrce")
    ap.add_argument("--arch", choices=list_archs(), default="deepseek-7b")
    ap.add_argument("--full-config", action="store_true",
                    help="the full (multi-billion-parameter) config")
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--silos", type=int, default=8)
    ap.add_argument("--participants", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--samples", type=int, default=6000)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--psi", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "paper":
        args.participants = min(args.participants, args.clients)
        run_paper_mode(args)
    else:
        args.participants = min(args.participants, args.silos)
        run_pretrain_mode(args)


if __name__ == "__main__":
    main()
