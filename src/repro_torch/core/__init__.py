"""FLrce core: selection, relationship modeling, heuristics, early stopping."""
from repro_torch.core.server import FLrceServer, FLrceState

__all__ = ["FLrceServer", "FLrceState"]
