"""Resource accounting: energy (computation) and bytes (communication).

Paper Eq. 8/9: computation efficiency = accuracy / energy, communication
efficiency = accuracy / bandwidth.  Energy is an explicit FLOPs × J/FLOP
model of the paper's client device (Jetson Nano); all charges are host
float64 arithmetic, identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# J per FLOP (≈ sustained W / sustained FLOP/s)
DEVICE_PROFILES: Dict[str, float] = {
    # Jetson Nano: ~10 W at ~0.235 TFLOP/s fp16 sustained ≈ 4.3e-11 J/FLOP
    "jetson_nano": 4.3e-11,
    # the reference's second profile, a TPU v5e chip: ~200 W at 197 TFLOP/s
    # bf16 ≈ 1.0e-12 J/FLOP; an energy price for the ledger, not a speed
    "tpu_v5e": 1.0e-12,
}

BYTES_PER_PARAM = 4  # float32 transport, as in the paper


@dataclasses.dataclass
class ResourceLedger:
    """Accumulates energy (J) and bandwidth (bytes) across a FL job."""

    device: str = "jetson_nano"
    energy_j: float = 0.0
    bytes_up: float = 0.0
    bytes_down: float = 0.0
    rounds: int = 0
    # async rounds: arrivals by staleness τ.  Charges stay at departure (a
    # client trains and uploads in the round it is selected, whenever its
    # update lands), so the totals equal the synchronous run's.
    arrivals_by_staleness: Dict[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.device not in DEVICE_PROFILES:
            raise ValueError(
                f"unknown energy profile {self.device!r}; known: {sorted(DEVICE_PROFILES)}"
            )

    @property
    def joules_per_flop(self) -> float:
        return DEVICE_PROFILES[self.device]

    def charge_training(self, flops: float) -> None:
        self.energy_j += flops * self.joules_per_flop

    def charge_download(self, num_params: float, fraction: float = 1.0) -> None:
        self.bytes_down += num_params * BYTES_PER_PARAM * fraction

    def charge_upload(self, num_params: float, fraction: float = 1.0) -> None:
        self.bytes_up += num_params * BYTES_PER_PARAM * fraction

    def end_round(self) -> None:
        self.rounds += 1

    def record_arrivals(self, tau_hist) -> None:
        """Fold one round's arrival histogram (index = staleness τ) in."""
        for tau, count in enumerate(tau_hist):
            if int(count):
                self.arrivals_by_staleness[int(tau)] = (
                    self.arrivals_by_staleness.get(int(tau), 0) + int(count))

    @property
    def total_bytes(self) -> float:
        return self.bytes_up + self.bytes_down

    def summary(self) -> Dict[str, float]:
        return {
            "rounds": self.rounds,
            "energy_kj": self.energy_j / 1e3,
            "bytes_gb": self.total_bytes / 1e9,
            "bytes_up_gb": self.bytes_up / 1e9,
            "bytes_down_gb": self.bytes_down / 1e9,
        }


def computation_efficiency(accuracy: float, energy_j: float) -> float:
    """Eq. 8 (raw ratio)."""
    return accuracy / max(energy_j, 1e-12)


def communication_efficiency(accuracy: float, total_bytes: float) -> float:
    """Eq. 9."""
    return accuracy / max(total_bytes, 1e-12)
