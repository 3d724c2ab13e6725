"""Federated learning engine of the port: strategies, cohort training, rounds."""
from repro_torch.fl.flrce import FLrce, TorchFLrce
from repro_torch.fl.rounds import FLResult, RoundRecord, run_federated
from repro_torch.fl.strategy import LocalConfig, Strategy, TorchStrategy

__all__ = [
    "FLrce",
    "TorchFLrce",
    "FLResult",
    "RoundRecord",
    "run_federated",
    "LocalConfig",
    "Strategy",
    "TorchStrategy",
]
