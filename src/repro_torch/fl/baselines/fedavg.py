"""FedAvg [3]: the unmodified base strategy (also `FLrce w/o selection+ES`)."""
from repro_torch.fl.strategy import TorchStrategy


# named apart from the reference's FedAvg for its lint; see baselines/__init__.py
class TorchFedAvg(TorchStrategy):
    """Uniform random selection, full local training (the base strategy)."""

    supports_scan = True
    # no per-round bookkeeping: under staleness only Eq. 4's timing changes
    supports_async = True


FedAvg = TorchFedAvg
