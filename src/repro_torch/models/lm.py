"""Transformer LMs behind the FL classifier protocol, from the reference's
``src/repro/models/lm.py``.

:class:`LMClassifier` wraps :class:`repro_torch.models.transformer.TransformerLM`
so the federated engines, which speak ``loss(params, x, y)`` over
``(N, *feat)`` float tensors, train a language model without a special code
path.  The dataset convention (:func:`repro_torch.data.lm.make_federated_lm`):

* ``x`` — ``(N, L)`` float32 **token ids** (exact below 2**24);
* ``y`` — ``(N,)`` int: the next token after the sequence.

``loss`` supervises every next-token position (labels ``[x[1:], y]``) and
``accuracy`` is top-1 at the final position against ``y``.

For a model with experts the two engines train two functions, as in the
reference.  ``loss``, which the sequential engine (``ClientTrainer``) calls,
routes the batch's tokens together and adds the batch's load-balance loss;
``per_example_loss``, which the batched engine calls, routes each sequence
alone and adds its own, as the reference's ``jax.vmap`` of ``model.loss``
over one-sequence batches does.  Without experts they agree.

Parameters are a flat dict in the reference's pytree leaf order, element for
element the reference's flattened vector: the layers of pattern position
``pos`` stacked over the NC cycles as ``decoder.cycles.<pos>.<leaf>`` with a
leading (NC,) axis, the ``num_layers % len(pattern)`` layers after them as
``decoder.rest.<r>.<leaf>``, then ``embed``, ``final_norm.*`` and
``unembed`` (dict keys sorted at every level, lists in order).  The forward
pass unstacks the cycles into ``TransformerLM``'s per-layer list.

The reference's ``param_specs(mesh)`` (the sharding policy's layouts for the
multi-device engines) is mesh work and waits for ROADMAP A.9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.distributed import flatten_tree
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import TransformerLM

Params = Dict[str, torch.Tensor]


def _set(node: Dict, parts: List[str], value) -> None:
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def lm_tree(cfg: ArchConfig, layers: List[Dict]) -> Dict[str, Any]:
    """The reference's stacked decoder (``{"cycles", "rest"}``) from a
    per-layer list in run order."""
    plen = len(cfg.pattern)
    nc, rest = divmod(cfg.num_layers, plen)
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers, {cfg.name} has {cfg.num_layers}")

    def stacked(trees):
        if isinstance(trees[0], dict):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    cycles = [stacked([layers[c * plen + pos] for c in range(nc)]) if nc else None
              for pos in range(plen)]
    return {"cycles": cycles, "rest": list(layers[nc * plen:])}


def flat_from_lm(cfg: ArchConfig, params: Dict[str, Any]) -> Params:
    """``LMClassifier``'s flat dict from ``TransformerLM``'s parameters."""
    tree = {k: v for k, v in params.items() if k != "layers"}
    tree["decoder"] = lm_tree(cfg, params["layers"])
    return flatten_tree(tree)


def lm_from_flat(cfg: ArchConfig, flat: Params) -> Dict[str, Any]:
    """``TransformerLM``'s parameters (a per-layer list) as views of the flat
    dict: cycle leaves are unbound along their (NC,) axis, so autograd
    gathers a stacked leaf's gradient in one stack."""
    plen = len(cfg.pattern)
    nc = cfg.num_layers // plen
    layers: List[Dict] = [{} for _ in range(cfg.num_layers)]
    out: Dict[str, Any] = {"layers": layers}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] != "decoder":
            _set(out, parts, t)
        elif parts[1] == "cycles":
            pos = int(parts[2])
            for c, piece in enumerate(t.unbind(0)):
                _set(layers[c * plen + pos], parts[3:], piece)
        else:
            _set(layers[nc * plen + int(parts[2])], parts[3:], t)
    return out


@dataclasses.dataclass(frozen=True)
class LMClassifier:
    """``TransformerLM`` as a federated classifier model.

    ``seq_len`` is the dataset's sequence length, used only by the analytic
    ``flops_per_sample`` the resource ledger charges (6·N·L for fwd+bwd).
    """

    cfg: ArchConfig
    seq_len: int
    remat: bool = True
    name: str = "lm"

    # The batched engine trains an LM's cohort one client at a time with
    # plain autograd: ``remat``'s ``torch.utils.checkpoint`` does not run
    # under ``torch.func``'s transforms, which the vmapped step is made of.
    vmap_clients = False

    @property
    def lm(self) -> TransformerLM:
        return TransformerLM(self.cfg, remat=self.remat)

    def init(self, seed: int = 0, device: DeviceLike = "cuda") -> Params:
        """The reference's ``init(PRNGKey(seed))``, bitwise, drawn on
        ``device`` by ``TransformerLM.init`` and flattened."""
        return flat_from_lm(self.cfg, self.lm.init(seed, device))

    def _batch(self, x: torch.Tensor, y: torch.Tensor = None) -> Dict[str, torch.Tensor]:
        # token ids ride in the float32 feature tensor; exact below 2**24
        tokens = x.long()
        if y is None:
            return {"tokens": tokens}
        return {"tokens": tokens, "labels": torch.cat([tokens[:, 1:], y.long()[:, None]], dim=1)}

    def loss(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.lm.loss(lm_from_flat(self.cfg, params), self._batch(x, y))

    def per_example_loss(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(N,) each sequence's loss, ``loss`` of that sequence alone
        (``TransformerLM.sequence_losses``): with experts, each sequence is
        routed alone and adds its own aux, as the reference's batched engine
        computes it (``src/repro/fl/client.py:329-332``)."""
        return self.lm.sequence_losses(lm_from_flat(self.cfg, params), self._batch(x, y))

    def accuracy(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        lm = self.lm
        tree = lm_from_flat(self.cfg, params)
        h = lm.hidden(tree, self._batch(x))
        logits = lm.unembed(tree, h[:, -1, :])
        return (torch.argmax(logits, dim=-1) == y.long()).float().mean()

    def flops_per_sample(self) -> float:
        # 6·N FLOPs/token for fwd+bwd (2N fwd, 4N bwd)
        return 6.0 * self.cfg.active_param_count() * self.seq_len
