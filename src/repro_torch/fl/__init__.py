"""Federated learning engine of the port: strategies, cohort training, rounds."""
from repro_torch.fl.aggregation import aggregation_weights, staleness_weights
from repro_torch.fl.async_rounds import AsyncConfig, staleness_of
from repro_torch.fl.flrce import FLrce, TorchFLrce
from repro_torch.fl.rounds import FLResult, RoundRecord, run_federated
from repro_torch.fl.strategy import LocalConfig, Strategy, TorchStrategy

__all__ = [
    "aggregation_weights",
    "staleness_weights",
    "AsyncConfig",
    "staleness_of",
    "FLrce",
    "TorchFLrce",
    "FLResult",
    "RoundRecord",
    "run_federated",
    "LocalConfig",
    "Strategy",
    "TorchStrategy",
]
