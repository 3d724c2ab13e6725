"""Optimizers and learning-rate schedules over parameter trees, from the
reference's ``src/repro/optim``."""
from repro_torch.optim.optimizers import (
    Optimizer,
    OptState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    sgd,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "Optimizer",
    "OptState",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "sgd",
    "tree_leaves",
    "tree_map",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
]
