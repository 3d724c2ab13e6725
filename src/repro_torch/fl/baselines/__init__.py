"""Baseline efficient-FL strategies the paper compares against (§4.1).

The classes carry names of their own (``TorchFedcom`` …) and are exported
under the reference's names as well: the reference's strategy-conformance
lint keys classes by bare name across the whole source tree, so a port class
named like a reference class would replace that class's entry.
"""
from repro_torch.fl.baselines.dropout import Dropout, TorchDropout
from repro_torch.fl.baselines.fedavg import FedAvg, TorchFedAvg
from repro_torch.fl.baselines.fedcom import Fedcom, TorchFedcom
from repro_torch.fl.baselines.fedprox import Fedprox, TorchFedprox
from repro_torch.fl.baselines.pyramidfl import PyramidFL, TorchPyramidFL
from repro_torch.fl.baselines.quantized import QuantizedFL, TorchQuantizedFL
from repro_torch.fl.baselines.timelyfl import TimelyFL, TorchTimelyFL

__all__ = [
    "FedAvg", "Fedcom", "Fedprox", "Dropout", "PyramidFL", "QuantizedFL", "TimelyFL",
    "TorchFedAvg", "TorchFedcom", "TorchFedprox", "TorchDropout", "TorchPyramidFL",
    "TorchQuantizedFL", "TorchTimelyFL",
]
