"""SGD(+momentum) and AdamW as (init, update) pairs over parameter trees,
from the reference's ``src/repro/optim/optimizers.py``.

A tree is nested dicts and lists of tensors (``None`` stays ``None``), such
as ``TransformerLM``'s parameters or a flat parameter dict.  The interface
mirrors the reference's::

    opt = sgd(lr=0.1, momentum=0.9)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The step counter is an int32 0-d tensor on the parameters' device, so a
schedule (``lr`` as a callable of the step) computes on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Union

import torch

Tree = Any
Rate = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


class Optimizer(NamedTuple):
    init: Callable[[Tree], "OptState"]
    update: Callable[..., Any]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor      # () int32
    inner: Tree


def _zeros_like(tree: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


def _step0(tree: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(tree)[0].device)


def _rate(lr: Rate, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def sgd(lr: Rate, momentum: float = 0.0) -> Optimizer:
    """Plain SGD; with momentum buffers when ``momentum > 0``."""

    def init(params):
        inner = _zeros_like(params) if momentum > 0.0 else None
        return OptState(step=_step0(params), inner=inner)

    def update(grads, state: OptState, params=None):
        del params
        step = state.step + 1
        rate = _rate(lr, step)
        if momentum > 0.0:
            buf = tree_map(lambda m, g: momentum * m + g.float(), state.inner, grads)
            return tree_map(lambda m: -rate * m, buf), OptState(step=step, inner=buf)
        return tree_map(lambda g: -rate * g.float(), grads), OptState(step=step, inner=None)

    return Optimizer(init=init, update=update)


def adamw(lr: Rate, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with fp32 moments."""

    def init(params):
        return OptState(step=_step0(params),
                        inner={"m": _zeros_like(params), "v": _zeros_like(params)})

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        rate = _rate(lr, step)
        stepf = step.float()
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state.inner["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state.inner["v"], grads)

        def _upd(m_, v_, p=None):
            u = -(rate * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            if weight_decay and p is not None:
                u = u - rate * weight_decay * p.float()
            return u

        if params is not None:
            updates = tree_map(_upd, m, v, params)
        else:
            updates = tree_map(_upd, m, v)
        return updates, OptState(step=step, inner={"m": m, "v": v})

    return Optimizer(init=init, update=update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params + updates`` in fp32, cast back to each leaf's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)
