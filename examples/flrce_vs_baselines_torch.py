"""FLrce vs the paper's baselines on the PyTorch port, one synthetic non-iid
federation.

    PYTHONPATH=src python examples/flrce_vs_baselines_torch.py [--device cuda|cpu]

The federation and strategies of ``examples/flrce_vs_baselines.py`` (M = 24
clients, P = 5 a round, T = 30 rounds, E = 2 local epochs, lr 0.08, batch
32, seed 1, 24 features, Dir(0.1)) run through ``repro_torch``: FLrce,
FedAvg, Fedcom (keep 0.1), Fedprox, Dropout (keep 0.5), PyramidFL and
TimelyFL.  Prints the same Table-3-style comparison (final accuracy,
rounds, energy, bandwidth, the Eq. 8/9 efficiency metrics) and FLrce's gain
over the best baseline.  Runs on CUDA unless ``--device cpu`` is given.
"""
import argparse
from typing import Dict, List, Optional

from repro_torch.data import make_federated_classification
from repro_torch.device import resolve_device
from repro_torch.fl import FLrce, run_federated
from repro_torch.fl.baselines import Dropout, FedAvg, Fedcom, Fedprox, PyramidFL, TimelyFL
from repro_torch.models import MLPClassifier, param_count

M, P, T, EPOCHS = 24, 5, 30, 2


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the comparison; return each strategy's ``FLResult`` by name."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_federated_classification(
        num_clients=M, alpha=0.1, num_samples=5000, num_eval=1000,
        feature_dim=24, num_classes=10, noise=0.8, seed=1,
    )
    model = MLPClassifier(feature_dim=24, num_classes=10, hidden=(48, 32))
    dim = param_count(model.init(0, "cpu"))

    strategies = [
        FLrce(M, P, EPOCHS, dim=dim, es_threshold=P / 2, explore_decay=0.9, seed=1),
        FedAvg(M, P, EPOCHS, seed=1),
        Fedcom(M, P, EPOCHS, seed=1, keep_frac=0.1),
        Fedprox(M, P, EPOCHS, seed=1),
        Dropout(M, P, EPOCHS, seed=1, keep_rate=0.5),
        PyramidFL(M, P, EPOCHS, seed=1),
        TimelyFL(M, P, EPOCHS, seed=1),
    ]

    print(f"{'strategy':<11} {'acc':>6} {'rounds':>6} {'kJ':>8} {'MB':>8} "
          f"{'comp_eff':>9} {'comm_eff':>9}")
    results = {}
    for strat in strategies:
        res = run_federated(model, ds, strat, max_rounds=T, learning_rate=0.08,
                            batch_size=32, seed=1, torch_device=dev)
        results[strat.name] = res
        print(f"{strat.name:<11} {res.final_accuracy:6.3f} {res.rounds_run:6d} "
              f"{res.energy_kj:8.4f} {res.bytes_gb * 1e3:8.2f} "
              f"{res.computation_efficiency:9.3g} {res.communication_efficiency:9.3g}")

    best_comp = max(r.computation_efficiency for n, r in results.items() if n != "flrce")
    best_comm = max(r.communication_efficiency for n, r in results.items() if n != "flrce")
    fl = results["flrce"]
    print(f"\nFLrce computation-efficiency gain vs best baseline: "
          f"{(fl.computation_efficiency / best_comp - 1) * 100:+.1f}%")
    print(f"FLrce communication-efficiency gain vs best baseline: "
          f"{(fl.communication_efficiency / best_comm - 1) * 100:+.1f}%")
    return results


if __name__ == "__main__":
    main()
