"""Quickstart on the PyTorch port: FLrce on a synthetic non-iid federation.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The configuration of ``examples/quickstart.py`` (M = 20 clients, P = 5 a
round, T = 25 rounds, E = 2 local epochs, lr 0.08, ψ = P/2, explore decay
0.9) run through ``repro_torch``: relationship-based selection, heuristic
updates and early stopping, with resource accounting.  ``init(0)`` draws the
same initial weights as the JAX package, so both print the same rounds.
Runs on CUDA unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.data import make_federated_classification
from repro_torch.device import resolve_device
from repro_torch.fl import FLrce, run_federated
from repro_torch.models import MLPClassifier, param_count

M, P, T, EPOCHS = 20, 5, 25, 2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = resolve_device(args.device)

    ds = make_federated_classification(
        num_clients=M, alpha=0.1, num_samples=4000, num_eval=800,
        feature_dim=24, num_classes=10, noise=0.8, seed=0,
    )
    model = MLPClassifier(feature_dim=24, num_classes=10, hidden=(48, 32))
    dim = param_count(model.init(0, "cpu"))
    strategy = FLrce(
        num_clients=M, clients_per_round=P, local_epochs=EPOCHS, dim=dim,
        es_threshold=P / 2,          # the paper's recommended psi
        explore_decay=0.9,           # exploit sooner at this small T
        seed=0,
    )
    result = run_federated(
        model, ds, strategy, max_rounds=T, learning_rate=0.08, batch_size=32,
        seed=0, verbose=True, torch_device=dev,
    )

    print(f"\n=== FLrce quickstart summary ({dev.type}) ===")
    for k, v in result.summary().items():
        print(f"  {k}: {v}")
    if result.stopped_early:
        print(f"  early stopping saved {T - result.rounds_run} of {T} rounds")


if __name__ == "__main__":
    main()
