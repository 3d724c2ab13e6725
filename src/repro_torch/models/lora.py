"""LoRA adapter fine-tuning as a federated *model*, from the reference's
``src/repro/models/lora.py``.

:class:`LoRAClassifier` wraps any classifier model of the port
(``MLPClassifier``, ``PaperCNN``, ``LMClassifier``) so that only low-rank
adapter factors are trained, aggregated and transmitted: the wrapped
model's parameters are frozen constants, ``init`` returns the adapters, and
every ``loss``/``accuracy`` call evaluates the base model at the merged
weights

    W_eff = (W.float() + scale · A @ B).to(W.dtype)   (A: (..., d_in, r), B: (..., r, d_out))

Over a bf16 base the merge rounds to bf16 as the reference's does, so a
delta below half an ulp of W vanishes in the forward pass; the unmerged
``x@W + (x@A)@B`` would be a different function.  The frozen base keeps its
dtype and is never stacked or copied per client; the adapters are fp32.

The FL engines derive everything from the trained dict (the flat (P, D)
round buffer, Eq. 4, FLrce's V/A ingest, the ledger's ``param_count``
charges), so the adapter regime needs no engine changes.  Adapters are a
*param-subset* model (``param_subset = True``): strategies whose variants
presume the full parameter vector (Dropout's masks, TimelyFL's layer
freezing) declare ``supports_param_subset = False`` and ``run_federated``
rejects them.

A stacked leaf adapts slice by slice: an LM's cycle leaves (NC, d_in,
d_out) and a mixture-of-experts MLP's (NC, E, d_in, d_out) ``wi``, ``wg``
and ``wo`` get A (…, d_in, r) and B (…, r, d_out) over the same leading
dims; an MoE's ``router`` matches no target and stays frozen.  ``loss`` and
``per_example_loss`` evaluate the base's two functions at the merged
weights, which for an MoE differ (``models/lm.py``): the sequential engine
trains the batch-routed one, the batched engine the per-sequence one.

Adapter names and order: a target leaf ``n`` of the base dict gets ``n.a``
and ``n.b``; under ``train_rest`` a non-target leaf ``n`` trains as ``n``.
The reference keys its adapter dict by path strings (``n`` with ``/`` for
``.``), which its pytree flattening sorts as strings, so the dict here is in
that order (``.../10/...`` before ``.../2/...``), ``a`` before ``b``.  ``init``
draws A in the base's leaf order, one ``split`` each, with the reference's
generator (``repro_torch.random``), so ``init(seed)`` equals the reference's
``init(PRNGKey(seed))`` bitwise.

Modes, as in the reference: the default trains A ~ N(0, 1/d_in) and B = 0
(the merged model starts at the base weights).  ``exact=True`` forces the
rank to min(d_in, d_out), fixes the square factor to the identity and
trains only the other one, from zero, so SGD on the adapter is full-matrix
SGD; with ``train_rest=True`` the non-target leaves train as passthrough
entries.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

# leaf names treated as low-rank targets: transformer attention/MLP
# projections (wq/wk/wv/wo/wi/wg) and the dense/conv "w" of the paper's
# MLP/CNN models.  Embedding/unembedding/norm leaves never match.
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "wi", "wg", "w")


class LoRAClassifier:
    """Adapter-only federated training over a frozen base model."""

    param_subset = True

    def __init__(self, base, base_params: Params, rank: int, *, scale: float = 1.0,
                 targets: Sequence[str] = DEFAULT_TARGETS, exact: bool = False,
                 train_rest: bool = False):
        self.base = base
        self.base_params = dict(base_params)
        self.rank = int(rank)
        self.scale = float(scale)
        self.targets = tuple(targets)
        self.exact = bool(exact)
        self.train_rest = bool(train_rest)
        self.name = f"lora-{getattr(base, 'name', 'model')}"
        self.vmap_clients = getattr(base, "vmap_clients", True)
        # every base leaf, in its order: (name, kind, shape); a 2+D leaf
        # whose last name part is a target gets factors, the rest are frozen
        # (or passthrough-trained under train_rest)
        self._plan: List[Tuple[str, str, Tuple[int, ...]]] = []
        for name, leaf in self.base_params.items():
            kind = "target" if leaf.dim() >= 2 and name.split(".")[-1] in self.targets else "rest"
            self._plan.append((name, kind, tuple(leaf.shape)))
        if not any(kind == "target" for _, kind, _ in self._plan):
            raise ValueError(f"no adapter targets matched {self.targets} in "
                             f"{getattr(base, 'name', 'model')}'s params")

    # -- adapter geometry ------------------------------------------------------
    def _target_rank(self, d_in: int, d_out: int) -> int:
        return min(d_in, d_out) if self.exact else min(self.rank, d_in, d_out)

    def adapter_dim(self) -> int:
        """Flat dimension of the trained dict: the D the ledger charges."""
        total = 0
        for _, kind, shape in self._plan:
            if kind == "target":
                *lead, d_in, d_out = shape
                r = self._target_rank(d_in, d_out)
                width = max(d_in, d_out) if self.exact else d_in + d_out
                total += int(np.prod(lead, dtype=np.int64)) * r * width
            elif self.train_rest:
                total += int(np.prod(shape, dtype=np.int64))
        return total

    def _entries(self, name: str, kind: str, shape) -> List[Tuple[str, Tuple[int, ...]]]:
        """The adapter leaves one base leaf contributes: (name, shape)."""
        if kind == "rest":
            return [(name, shape)] if self.train_rest else []
        *lead, d_in, d_out = shape
        r = self._target_rank(d_in, d_out)
        a, b = (f"{name}.a", (*lead, d_in, r)), (f"{name}.b", (*lead, r, d_out))
        if self.exact:
            return [b] if d_in <= d_out else [a]
        return [a, b]

    def adapter_leaves(self) -> List[Tuple[str, str, Optional[str]]]:
        """Every trained leaf as (name, base leaf name, factor ``"a"``/``"b"``,
        or ``None`` for a passthrough leaf), in the reference's order: base
        names as '/'-paths, sorted as strings, ``a`` before ``b``."""
        groups: Dict[str, List[Tuple[str, str, Optional[str]]]] = {}
        for name, kind, shape in self._plan:
            entries = [(n, name, None if kind == "rest" else n[-1])
                       for n, _ in self._entries(name, kind, shape)]
            if entries:
                groups[name.replace(".", "/")] = entries
        return [e for key in sorted(groups) for e in groups[key]]

    def _sorted(self, adapters: Params) -> Params:
        return {n: adapters[n] for n, _, _ in self.adapter_leaves()}

    # -- the classifier protocol -------------------------------------------------
    def a_keys(self, seed: int) -> Dict[str, np.ndarray]:
        """Each drawn A factor's key, in the base's leaf order: one ``split``
        of the chain from ``PRNGKey(seed)`` each, as the reference draws them."""
        key, out = random.PRNGKey(seed), {}
        if self.exact:
            return out
        for name, kind, shape in self._plan:
            if kind != "rest":
                for n, _ in self._entries(name, kind, shape):
                    if n.endswith(".a"):
                        key, out[n] = random.split(key)
        return out

    def init(self, seed: int = 0, device: DeviceLike = "cuda") -> Params:
        """The reference's ``init(PRNGKey(seed))``: A from :meth:`a_keys`,
        scaled by 1/sqrt(d_in) in fp32, B zero.  The keys are host work;
        each A's normals are drawn on ``device`` (``ops.random_normal``: the
        Threefry kernel on the card)."""
        dev = resolve_device(device)
        keys = self.a_keys(seed)
        out: Params = {}
        for name, kind, shape in self._plan:
            if kind == "rest":
                if self.train_rest:
                    out[name] = self.base_params[name].detach().clone().to(dev)
                continue
            for n, s in self._entries(name, kind, shape):
                if n in keys:
                    # divided by a tensor: a CUDA division by a Python
                    # scalar multiplies by its reciprocal instead
                    root = torch.tensor(float(np.sqrt(np.float32(shape[-2]))), device=dev)
                    out[n] = ops.random_normal(keys[n], math.prod(s), dev).reshape(s) / root
                else:
                    out[n] = torch.zeros(s, dtype=torch.float32, device=dev)
        return self._sorted(out)

    def merge(self, adapters: Params) -> Params:
        """Base params with every adapter folded in: the full-model dict the
        wrapped model evaluates (and the eval/deploy artifact)."""
        merged: Params = {}
        for name, kind, shape in self._plan:
            leaf = self.base_params[name]
            if kind == "target":
                d_in, d_out = shape[-2:]
                r = self._target_rank(d_in, d_out)
                a: Optional[torch.Tensor] = adapters.get(f"{name}.a")
                b: Optional[torch.Tensor] = adapters.get(f"{name}.b")
                if self.exact:
                    eye = torch.eye(r, dtype=torch.float32, device=leaf.device)
                    a = eye if a is None else a
                    b = eye if b is None else b
                delta = torch.matmul(a, b)
                if self.scale != 1.0:       # x·1.0 is x: skip a pass over W
                    delta = self.scale * delta
                # fp32 delta + W: the add promotes W to fp32 in the same
                # pass, as the reference's W.astype(f32) + delta
                merged[name] = (delta + leaf).to(leaf.dtype)
            elif self.train_rest:
                merged[name] = adapters[name]
            else:
                merged[name] = leaf
        return merged

    def loss(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.base.loss(self.merge(params), x, y)

    def per_example_loss(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.base.per_example_loss(self.merge(params), x, y)

    def accuracy(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.base.accuracy(self.merge(params), x, y)

    def flops_per_sample(self) -> float:
        # training still runs fwd+bwd through the full base model; the
        # adapter contraction is a rounding error on top
        return self.base.flops_per_sample()
