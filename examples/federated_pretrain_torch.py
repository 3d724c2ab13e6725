"""Cross-silo federated pretraining of a transformer LM with FLrce
server-side control, on the PyTorch port.

    # ~15M-param model, quick demo (default)
    PYTHONPATH=src python examples/federated_pretrain_torch.py [--device cuda|cpu]

    # ~100M-param model on the card
    PYTHONPATH=src python examples/federated_pretrain_torch.py --size 100m --rounds 25

``examples/federated_pretrain.py`` on ``repro_torch``, with its ``SIZES``,
its config (fp32, gated SiLU MLP, RMSNorm, global attention) and its flags.
Each silo draws from its own topic-skewed Zipf-Markov token stream; the
job runs through ``run_federated(driver="scan")``, the compiled path: local
SGD, Eq. 4 aggregation, relationship modelling over the deltas (Alg. 1),
explore/exploit selection (Alg. 2) and the conflict-based early stop
(Alg. 3) run inside one captured round per ``--chunk`` rounds' chunk, with
one host sync a chunk.  The reference passes ``engine="sharded"`` over a
``(data, model)`` mesh; the port's mesh engine waits for ROADMAP A.8, so
this runs ``engine="batched"``, which the reference's ``(1, 1)`` mesh on
one device equals.  Where the reference reports ``compiles_chunk`` (XLA
compilations of chunk programs), the port reports ``captures_chunk`` (CUDA
graphs captured while dispatching chunks).  Runs on CUDA unless
``--device cpu`` is given.
"""
import argparse
import json
import time
from typing import List, Optional

from repro_torch.configs.base import ATTN_GLOBAL, ArchConfig
from repro_torch.data import make_federated_lm
from repro_torch.device import resolve_device
from repro_torch.fl import FLrce, run_federated
from repro_torch.models import LMClassifier, param_count

SIZES = {
    # name: (layers, d_model, heads, d_ff, vocab); parameters 2,098,304,
    # 14,683,392 and 100,680,192
    "5m": (4, 128, 4, 512, 4096),
    "20m": (6, 256, 8, 1024, 16_384),
    "100m": (16, 512, 8, 2048, 32_768),
}


def make_cfg(size: str) -> ArchConfig:
    nl, d, h, f, v = SIZES[size]
    return ArchConfig(
        name=f"fedlm-{size}", family="dense", num_layers=nl, d_model=d,
        num_heads=h, num_kv_heads=h, d_ff=f, vocab_size=v,
        pattern=(ATTN_GLOBAL,), norm="rmsnorm", act="silu", gated_mlp=True,
        dtype="float32",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", choices=sorted(SIZES), default="20m")
    ap.add_argument("--silos", type=int, default=8)
    ap.add_argument("--participants", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--psi", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def setup(args):
    """(model, dataset, strategy, ψ, device) of a run: the reference
    example's federation for ``args``."""
    dev = resolve_device(args.device)
    cfg = make_cfg(args.size)
    model = LMClassifier(cfg, seq_len=args.seq)
    dim = param_count(model.init(args.seed, dev))
    print(f"[fedlm] {cfg.name}: {dim:,} params, {args.silos} silos, "
          f"{args.participants}/round, {args.rounds} rounds, 1 device(s) ({dev.type})")
    # one local epoch over batch*local_steps samples/silo = --local-steps
    # SGD steps per selected silo per round, as in the hand-rolled loop
    ds = make_federated_lm(
        num_clients=args.silos, samples_per_client=args.batch * args.local_steps,
        seq_len=args.seq, vocab_size=cfg.vocab_size, num_eval=8 * args.batch,
        alpha=0.25, seed=args.seed,
    )
    psi = args.psi if args.psi is not None else args.participants / 2
    strategy = FLrce(args.silos, args.participants, 1, dim=dim,
                     es_threshold=psi, explore_decay=0.85, seed=args.seed)
    return model, ds, strategy, psi, dev


def main(argv: Optional[List[str]] = None):
    """Run the example; return its ``FLResult``."""
    args = build_parser().parse_args(argv)
    model, ds, strategy, psi, dev = setup(args)

    t0 = time.perf_counter()
    res = run_federated(
        model, ds, strategy,
        max_rounds=args.rounds, learning_rate=args.lr, batch_size=args.batch,
        seed=args.seed, engine="batched", driver="scan",
        scan_chunk_rounds=args.chunk, torch_device=dev,
    )
    wall = time.perf_counter() - t0

    for rec in res.records:
        print(json.dumps({
            "round": rec.t, "silos": [int(i) for i in rec.selected],
            "accuracy": round(float(rec.accuracy), 4),
            "mean_loss": round(float(rec.mean_client_loss), 4),
            "exploit": bool(rec.exploited), "stopped": bool(rec.stopped),
        }))
    if res.stopped_early:
        print(f"[fedlm] early stop at round {res.rounds_run - 1} "
              f"(psi={psi}) — saved {args.rounds - res.rounds_run} rounds")
    print(f"[fedlm] done: {res.rounds_run} rounds in {wall:.1f}s "
          f"({res.driver_stats.get('captures_chunk', '?')} chunk capture(s)), "
          f"next-token acc {float(res.final_accuracy):.4f}, "
          f"uploaded {res.ledger.bytes_up / 2**20:.1f} MiB")
    return res


if __name__ == "__main__":
    main()
