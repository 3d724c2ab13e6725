"""Client-side local training (paper Eq. 3).

Two paths compute the same math:

* :class:`ClientTrainer` — the sequential oracle: one plain autograd SGD
  step per batch, client by client, from Python.
* :class:`BatchedCohortTrainer` — the production path.

:class:`BatchedCohortTrainer` runs every selected client's local epochs
together: per-client parameters are stacked along a leading client axis and
one SGD step of the whole cohort is ``torch.func.vmap`` of ``grad`` over that
axis.  A Python loop over the padded step axis takes the place of the
reference's ``lax.scan``.  A model with ``vmap_clients = False`` (the
language models, whose ``remat`` checkpointing does not run under
``torch.func``) takes the same steps one client at a time with plain
autograd, on the same schedule, gates and weights.  The returned update is
``w_local − w_global`` after all local epochs, flattened in the reference's
leaf order.

Variants cover the baselines' local tweaks, as in the reference:

* ``prox_mu``     — Fedprox proximal term µ/2·‖q − w_global‖² on the masked
  params q;
* ``mask``        — Dropout sub-model training (masked params, grads and
  update);
* ``freeze_frac`` — TimelyFL layer freezing (the first
  ``int(freeze_frac · n_leaves)`` leaves in leaf order get no update).

The batch schedule (:func:`build_cohort_plan`) is host NumPy, bitwise the
reference's: ragged clients are padded within a batch (zero sample weight)
and along the step axis (zero step validity), and a padded step changes no
parameter.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.distributed import flatten_rows
from repro_torch.data.loader import bucket_steps, epoch_batches
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def client_batch_rng(seed: int, t: int, cid: int) -> np.random.Generator:
    """Placement-independent batch RNG: one stream per (seed, round, client)."""
    entropy = [int(seed) & 0xFFFFFFFFFFFFFFFF, int(t), int(cid)]
    return np.random.default_rng(np.random.SeedSequence(entropy))


@dataclasses.dataclass
class CohortPlan:
    """Padded batch schedule for one round's selected cohort (host arrays)."""

    x: np.ndarray            # (P, S, B, *feat) float32
    y: np.ndarray            # (P, S, B) int32
    sample_w: np.ndarray     # (P, S, B) float32: 1 = real sample, 0 = pad
    step_valid: np.ndarray   # (P, S) float32: 1 = real step, 0 = pad
    epochs: List[int]
    num_samples: List[int]

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def num_steps(self) -> int:
        return self.x.shape[1]


def build_cohort_plan(
    client_data: Sequence[Tuple[np.ndarray, np.ndarray]],
    epochs: Sequence[int],
    batch_size: int,
    rngs: Sequence[np.random.Generator],
) -> CohortPlan:
    """Stack every selected client's shuffled epoch batches into one schedule.

    ``rngs`` holds one Generator per client (the :func:`client_batch_rng`
    streams), each consumed epoch by epoch with one ``permutation`` per epoch.
    """
    if not client_data:
        raise ValueError("empty cohort")
    rngs = list(rngs)
    if len(rngs) != len(client_data):
        raise ValueError(f"got {len(rngs)} per-client rngs, expected {len(client_data)}")
    feat = client_data[0][0].shape[1:]
    per_client = []
    steps_per_client: List[int] = []
    for (x, y), e, rng_k in zip(client_data, epochs, rngs):
        n = len(x)
        nb = -(-n // batch_size) if n else 0
        s_k = max(1, int(e)) * nb
        bx = np.zeros((s_k, batch_size, *feat), np.float32)
        by = np.zeros((s_k, batch_size), np.int32)
        bw = np.zeros((s_k, batch_size), np.float32)
        s = 0
        for _ in range(max(1, int(e))):
            order = rng_k.permutation(n)
            for start in range(0, n, batch_size):
                ix = order[start : start + batch_size]
                bx[s, : len(ix)] = x[ix]
                by[s, : len(ix)] = y[ix]
                bw[s, : len(ix)] = 1.0
                s += 1
        per_client.append((bx, by, bw))
        steps_per_client.append(s_k)

    s_max = max(max(steps_per_client), 1)
    s_pad = bucket_steps(s_max)
    p = len(client_data)
    px = np.zeros((p, s_pad, batch_size, *feat), np.float32)
    py = np.zeros((p, s_pad, batch_size), np.int32)
    pw = np.zeros((p, s_pad, batch_size), np.float32)
    pv = np.zeros((p, s_pad), np.float32)
    for k, (bx, by, bw) in enumerate(per_client):
        s_k = steps_per_client[k]
        px[k, :s_k], py[k, :s_k], pw[k, :s_k] = bx, by, bw
        pv[k, :s_k] = 1.0
    return CohortPlan(
        x=px, y=py, sample_w=pw, step_valid=pv,
        epochs=[max(1, int(e)) for e in epochs],
        num_samples=[len(x) for x, _ in client_data],
    )


def mean_losses(losses: np.ndarray, step_valid: np.ndarray) -> List[float]:
    """Each client's mean loss over its valid steps (NaN for none) from the
    (P, S) loss trace."""
    return [float(np.mean(lk[v > 0])) if (v > 0).any() else float("nan")
            for lk, v in zip(losses, step_valid)]


def cohort_stats(losses: np.ndarray, plan: CohortPlan) -> List[Dict[str, float]]:
    """Per-client stats from the (P, S) loss trace, over valid steps only."""
    out: List[Dict[str, float]] = []
    means = mean_losses(losses, plan.step_valid)
    for k in range(plan.num_clients):
        v = plan.step_valid[k] > 0
        lk = losses[k][v]
        out.append({
            "mean_loss": means[k],
            "final_loss": float(lk[-1]) if lk.size else float("nan"),
            "samples_processed": float(plan.sample_w[k].sum()),
            "steps": float(v.sum()),
        })
    return out


def freeze_flags(n_leaves: int, freeze_frac: float) -> np.ndarray:
    """1.0 for trainable leaves, 0.0 for the frozen prefix (layer freezing):
    the first ``int(freeze_frac · n_leaves)`` leaves in leaf order."""
    n_frozen = int(freeze_frac * n_leaves)
    return np.array([0.0 if i < n_frozen else 1.0 for i in range(n_leaves)], np.float32)


def client_loss(model, params: Params, x, y, w, mask: Optional[Params], anchor: Params, mu,
                use_prox: bool):
    """One client's local loss on the batched engines: per-example losses ×
    sample weights, summed and divided by ``max(Σw, 1)``, on the params times
    the mask when there is one, plus µ/2·‖q − anchor‖² over all leaves of the
    masked params q (in leaf order) when ``use_prox``."""
    q = {k: params[k] * mask[k] for k in params} if mask is not None else params
    per = model.per_example_loss(q, x, y)
    loss = torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)
    if use_prox:
        sq = sum(torch.sum(torch.square(q[k] - anchor[k])) for k in q)
        loss = loss + 0.5 * mu * sq
    return loss


def sgd_leaf(p: torch.Tensor, g: torch.Tensor, lr: float, mask=None, gate=None) -> torch.Tensor:
    """One leaf's local SGD update ``p − lr·(g·mask·gate)``: the gradient is
    multiplied by the mask, then by the gate (freeze flag × step validity),
    each when given."""
    if mask is not None:
        g = g * mask
    if gate is not None:
        g = g * gate
    return p - lr * g


def masked_update(params: Params, global_params: Params, mask: Optional[Params]) -> torch.Tensor:
    """The flat (P, D) update ``(w_local − w_global)·mask`` of stacked params."""
    update = {k: params[k] - global_params[k] for k in params}
    if mask is not None:
        update = {k: update[k] * mask[k] for k in update}
    return flatten_rows(update)


class ClientTrainer:
    """Runs one client's E local epochs of SGD, a batch per Python step.

    Each step takes the mean cross-entropy of the batch, on the params times
    the client's mask when it has one, plus the prox term µ/2·Σ‖q − w_global‖²
    over all leaves of the masked params q when µ > 0.  The gradient is
    multiplied by the mask, then by the leaf's freeze flag (the first
    ``int(freeze_frac · n_leaves)`` leaves get none) before the SGD update.
    The update ``w_local − w_global`` is multiplied by the mask too.
    """

    def __init__(self, model, learning_rate: float, batch_size: int, device: DeviceLike = "cuda"):
        self.model = model
        self.lr = float(learning_rate)
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def _step(self, params: Params, anchor: Params, x, y, mask, freeze, prox_mu: float):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            q = {k: leaves[k] * mask[k] for k in leaves} if mask is not None else leaves
            loss = self.model.loss(q, x, y)
            if prox_mu > 0.0:
                sq = sum(torch.sum(torch.square(q[k] - anchor[k])) for k in q)
                loss = loss + 0.5 * prox_mu * sq
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            new = {k: sgd_leaf(p, g, self.lr, None if mask is None else mask[k],
                               None if freeze is None else freeze[k])
                   for (k, p), g in zip(params.items(), grads)}
        return new, loss.detach()

    def local_update(
        self,
        global_params: Params,
        x: np.ndarray,
        y: np.ndarray,
        epochs: int,
        rng: np.random.Generator,
        *,
        prox_mu: float = 0.0,
        mask: Optional[Params] = None,
        freeze_frac: float = 0.0,
    ) -> Tuple[Params, Dict[str, float]]:
        """Returns (update dict u_k in leaf order, stats)."""
        dev = self.device
        if mask is not None:
            mask = {k: mask[k].to(device=dev, dtype=v.dtype) for k, v in global_params.items()}
        freeze = None
        if freeze_frac > 0:
            flags = freeze_flags(len(global_params), freeze_frac)
            freeze = {k: float(f) for k, f in zip(global_params, flags)}
        params = global_params
        losses: List[torch.Tensor] = []
        n_samples = 0
        for _ in range(max(1, epochs)):
            for bx, by in epoch_batches(x, y, self.batch_size, rng):
                params, loss = self._step(
                    params, global_params, torch.from_numpy(bx).to(dev),
                    torch.from_numpy(by).to(dev).long(), mask, freeze, prox_mu,
                )
                losses.append(loss)
                n_samples += len(bx)
        with torch.no_grad():
            update = {k: params[k] - global_params[k] for k in params}
            if mask is not None:
                update = {k: update[k] * mask[k] for k in update}
        trace = torch.stack(losses).cpu().numpy().astype(np.float64) if losses else np.zeros(0)
        stats = {
            "mean_loss": float(np.mean(trace)) if trace.size else float("nan"),
            "final_loss": float(trace[-1]) if trace.size else float("nan"),
            "samples_processed": float(n_samples),
            "steps": float(trace.size),
        }
        return update, stats


def stack_freeze_flags(n_leaves: int, freeze_fracs: Sequence[float]) -> np.ndarray:
    """(n_leaves, P) per-leaf trainability flags of a cohort."""
    return np.stack([freeze_flags(n_leaves, float(f)) for f in freeze_fracs], axis=1)


def stack_variant_trees(masks: Sequence[Optional[Params]], template: Params) -> Optional[Params]:
    """Stack per-client mask dicts along a new leading axis, leaf by leaf.

    A client without a mask gets all ones (multiplying by 1.0 is exact in
    fp32, so it is untouched).  ``None`` when no client has a mask: the step
    then skips masking entirely.
    """
    if all(m is None for m in masks):
        return None
    return {
        k: torch.stack([
            torch.ones_like(v) if m is None else m[k].to(device=v.device, dtype=v.dtype)
            for m in masks
        ])
        for k, v in template.items()
    }


class BatchedCohortTrainer:
    """Runs all P selected clients' local epochs as one batched computation.

    Each step: ``vmap(grad_and_value(loss))`` over the client axis, where a
    client's loss is its per-example losses × sample weights, summed and
    divided by ``max(Σw, 1)``, plus the prox term when some client has
    µ > 0, on the params times the client's mask when some client has one.
    The gradient is multiplied by the mask, then by the leaf's freeze flag ×
    the step's validity before the SGD update, so a padded step leaves the
    parameters bitwise unchanged.  :meth:`train_cohort` does not run the
    steps past the last valid step of every client (such no-ops for the
    whole cohort); the compiled driver runs them all (:meth:`run_steps`).  Without prox
    and masks (FedAvg) the step is the plain weighted loss.
    """

    def __init__(self, model, learning_rate: float, batch_size: int, device: DeviceLike = "cuda"):
        self.model = model
        self.lr = float(learning_rate)
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._steps: Dict[Tuple[bool, bool], object] = {}

    def _step(self, use_prox: bool, has_mask: bool):
        """The vmapped step for one (use_prox, has_mask) variant, built once."""
        key = (use_prox, has_mask)
        if key not in self._steps:
            model = self.model

            def loss(params: Params, x, y, w, mask, anchor, mu):
                return client_loss(model, params, x, y, w, mask, anchor, mu, use_prox)

            self._steps[key] = vmap(
                grad_and_value(loss),
                in_dims=(0, 0, 0, 0, 0 if has_mask else None, None, 0),
            )
        return self._steps[key]

    def run_steps(self, global_params: Params, n_steps: int, batch_at, sample_w, step_valid,
                  mask: Optional[Params], flags: torch.Tensor, mu: torch.Tensor,
                  use_prox: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first ``n_steps`` cohort steps of a (P, S) schedule, with no
        host read: ``batch_at(s)`` gives step s's ``(x (P, B, …), y (P, B))``,
        ``sample_w`` is (P, S, B), ``mask`` leaf → (P, …) or None, ``flags``
        the (n_leaves, P) freeze flags, ``mu`` (P,).  Returns the flat (P, D)
        update and the (P, S) losses, on the device.  The compiled driver
        runs all S steps, as the reference's ``lax.scan`` does (a step past a
        client's last is a bitwise no-op); :meth:`train_cohort` stops after
        the last valid step of any client."""
        has_mask = mask is not None
        if not getattr(self.model, "vmap_clients", True):
            return self._run_steps_per_client(global_params, n_steps, batch_at, sample_w,
                                              step_valid, mask, flags, mu, use_prox)
        step = self._step(use_prox, has_mask)
        p, s_pad = step_valid.shape
        # per-leaf (P, S) gates: the freeze flag times the step's validity,
        # the reference's f · v for every step at once
        gates = {k: flags[i][:, None] * step_valid for i, k in enumerate(global_params)}
        params = {k: v.unsqueeze(0).expand(p, *v.shape).clone() for k, v in global_params.items()}
        losses = torch.zeros((p, s_pad), dtype=torch.float32, device=step_valid.device)
        with torch.no_grad(), warnings.catch_warnings():
            if step_valid.is_cuda:
                # vmap runs unfold's backward (the card's patch convolution)
                # one client at a time, and says so once.  chip_smoke.py's
                # profile prints that backward's device time per round, and
                # --numerics times the vmapped step against cuDNN's.
                warnings.filterwarnings("ignore",
                                        message=".*batching rule for aten::unfold_backward")
            for s in range(n_steps):
                x, y = batch_at(s)
                grads, loss = step(params, x, y.long(), sample_w[:, s], mask, global_params, mu)
                for k in params:
                    gate = gates[k][:, s].view(-1, *([1] * (params[k].dim() - 1)))
                    params[k] = sgd_leaf(params[k], grads[k], self.lr,
                                         mask[k] if has_mask else None, gate)
                losses[:, s] = loss
            return masked_update(params, global_params, mask), losses

    def _run_steps_per_client(self, global_params: Params, n_steps: int, batch_at, sample_w,
                              step_valid, mask: Optional[Params], flags: torch.Tensor,
                              mu: torch.Tensor,
                              use_prox: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`run_steps` one client at a time: each client's step is one
        plain autograd gradient of :func:`client_loss`, on its own parameters
        (the global tensors themselves until its first step; a LoRA model's
        frozen base is never copied), updated by :func:`sgd_leaf`.  Only the
        looping differs from the vmapped step."""
        names = list(global_params)
        p, s_pad = step_valid.shape
        gates = {k: flags[i][:, None] * step_valid for i, k in enumerate(names)}
        masks = [None if mask is None else {n: mask[n][k] for n in names} for k in range(p)]
        clients = [dict(global_params) for _ in range(p)]
        losses = torch.zeros((p, s_pad), dtype=torch.float32, device=step_valid.device)
        for s in range(n_steps):
            x, y = batch_at(s)
            for k in range(p):
                leaves = {n: clients[k][n].detach().requires_grad_(True) for n in names}
                with torch.enable_grad():
                    loss = client_loss(self.model, leaves, x[k], y[k].long(), sample_w[k, s],
                                       masks[k], global_params, mu[k], use_prox)
                    grads = torch.autograd.grad(loss, list(leaves.values()))
                with torch.no_grad():
                    clients[k] = {n: sgd_leaf(leaves[n].detach(), g, self.lr,
                                              None if masks[k] is None else masks[k][n],
                                              gates[n][k, s])
                                  for n, g in zip(names, grads)}
                    losses[k, s] = loss.detach()
        with torch.no_grad():
            stacked = {n: torch.stack([c[n] for c in clients]) for n in names}
            return masked_update(stacked, global_params, mask), losses

    def train_cohort(
        self,
        global_params: Params,
        plan: CohortPlan,
        *,
        prox_mus: Sequence[float],
        masks: Sequence[Optional[Params]],
        freeze_fracs: Sequence[float],
    ) -> Tuple[torch.Tensor, List[Dict[str, float]]]:
        """Returns (flat (P, D) fp32 update matrix in leaf order, per-client stats)."""
        dev = self.device
        mask = stack_variant_trees(masks, global_params)
        use_prox = bool(np.any(np.asarray(prox_mus) > 0.0))
        mu = torch.from_numpy(np.asarray(prox_mus, np.float32)).to(dev)
        xs = torch.from_numpy(plan.x).to(dev)
        ys = torch.from_numpy(plan.y).to(dev)
        flags = torch.from_numpy(stack_freeze_flags(len(global_params), freeze_fracs)).to(dev)
        any_valid = np.flatnonzero(plan.step_valid.max(axis=0) > 0)
        n_steps = int(any_valid[-1]) + 1 if any_valid.size else 0
        flat, losses = self.run_steps(
            global_params, n_steps, lambda s: (xs[:, s], ys[:, s]),
            torch.from_numpy(plan.sample_w).to(dev), torch.from_numpy(plan.step_valid).to(dev),
            mask, flags, mu, use_prox)
        return flat, cohort_stats(losses.cpu().numpy(), plan)
