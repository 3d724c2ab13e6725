"""Step functions of the port's launchers, from the reference's
``src/repro/launch/steps.py``: train, prefill and the one-token serve step.
The FLrce server round step is ``core.server``'s."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.optimizers import Optimizer, apply_updates, tree_leaves, tree_map


def build_train_step(model: TransformerLM, optimizer: Optimizer) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    One gradient of ``model.loss`` through autograd, the optimizer's update
    and ``apply_updates``; ``metrics["loss"]`` is the fp32 loss."""

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        tracked = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            loss = model.loss(tracked, batch)
            grads_flat = torch.autograd.grad(loss, live)
        it = iter(grads_flat)
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, opt_state, params)
            new_params = apply_updates(params, updates)
        return new_params, new_opt, {"loss": loss.detach().float()}

    return train_step


def build_prefill_step(model: TransformerLM) -> Callable:
    """(params, batch) -> last-position logits (B, V): the full-sequence
    forward, without filling a cache."""

    def prefill_step(params, batch):
        with torch.no_grad():
            h = model.hidden(params, batch)
            return model.unembed(params, h[:, -1, :])

    return prefill_step


def build_serve_step(model: TransformerLM) -> Callable:
    """One-token decode: (params, tokens, cache, position) -> (next_token, logits, cache).

    The next token is the argmax of the last position's logits in their own
    dtype; on a tie the first index wins, as in the reference."""

    def serve_step(params, tokens: torch.Tensor, cache, position: int):
        logits, new_cache = model.decode_step(params, tokens, cache, position)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        return next_tok, logits, new_cache

    return serve_step
