"""Host data substrate: NumPy copies of the reference's datasets and batching."""
from repro_torch.data.lm import make_federated_lm
from repro_torch.data.loader import bucket_steps, epoch_batches
from repro_torch.data.partition import dirichlet_label_partition
from repro_torch.data.synthetic import (
    FederatedDataset,
    make_classification,
    make_federated_classification,
    make_image_like,
)
from repro_torch.data.tokens import SiloTokenStream

__all__ = [
    "bucket_steps",
    "epoch_batches",
    "dirichlet_label_partition",
    "FederatedDataset",
    "make_classification",
    "make_federated_classification",
    "make_image_like",
    "make_federated_lm",
    "SiloTokenStream",
]
