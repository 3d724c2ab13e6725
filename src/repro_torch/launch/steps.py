"""Step functions of the port's launchers, from the reference's
``src/repro/launch/steps.py``: the one-token serve step."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import TransformerLM


def build_serve_step(model: TransformerLM) -> Callable:
    """One-token decode: (params, tokens, cache, position) -> (next_token, logits, cache).

    The next token is the argmax of the last position's logits in their own
    dtype; on a tie the first index wins, as in the reference."""

    def serve_step(params, tokens: torch.Tensor, cache, position: int):
        logits, new_cache = model.decode_step(params, tokens, cache, position)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        return next_tok, logits, new_cache

    return serve_step
