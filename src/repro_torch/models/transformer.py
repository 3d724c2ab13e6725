"""Decoder-only LM, from the reference's ``src/repro/models/transformer.py``,
for the dense attention-only architectures (global and sliding-window
attention, dense MLP), the mixture-of-experts ones (mixtral-8x22b,
dbrx-132b: attention with an MoE MLP, ``models/moe.py``), the RG-LRU hybrid
(recurrentgemma-2b: Griffin recurrent blocks beside local attention) and
xLSTM (xlstm-1.3b: seven mLSTM blocks to one sLSTM block): the
full-sequence forward and the sequence-chunked cross-entropy of training
and prefill, and cached decoding.

Parameters are a dict::

    embed        (V, D)
    layers       list over the num_layers layers, in the order they run
    final_norm
    unembed      (D, V) unless cfg.tie_embeddings

The reference stacks layers by pattern position into scanned cycles and runs
cycle c's positions 0…len(pattern)−1 before cycle c+1, then the ``rest``
layers; flat layer i is therefore pattern position ``i % len(pattern)`` of
cycle ``i // len(pattern)``, and its kind is ``cfg.block_kind(i)``
(``convert.lm_params_from_jax`` maps the stacked pytree onto this list).
Each block is a pre-norm residual: ``norm1`` and the ``mixer`` (attention,
RG-LRU, mLSTM or sLSTM), then, for attention blocks of a model with
``d_ff > 0``, ``norm2`` and the MLP (dense, or ``moe.init_moe``'s router and
stacked (E, …) experts); a recurrent block has no MLP, as in the
reference (an RG-LRU block's
``ArchConfig.param_count()`` books one anyway: recurrentgemma-2b's built tree
has 2,304,888,320 parameters, the config's count says 2,835,637,760).
Caches are a matching list: ``{"k", "v"}`` for an attention layer, where a
local layer's cache is ``min(cache_len, window)`` long, a ring buffer;
``{"h", "conv_tail"}`` (fp32 state, the conv's last inputs) for an RG-LRU
layer, ``{"C", "n", "m"}`` for an mLSTM layer and ``{"c", "n", "m", "h"}``
for an sLSTM layer (fp32).

A model with experts sums its layers' load-balance losses (``aux``):
``hidden_aux`` returns it beside the hidden states, and ``loss`` is the
mean NLL plus aux, as the reference's.  ``hidden``, ``forward`` and
``nll_sums`` return the hidden states, the logits and the per-sequence NLL
alone, where the reference returns the first two beside aux; for a model
without experts aux is ``None`` and ``loss`` adds nothing.  Full sequences
route with the model's ``moe_capacity_factor`` and ``moe_group_size`` (the
reference's 1.25 and 2048), the decode step drop-free.  A batch routes its
tokens together and adds its aux (``loss``: the reference's ``model.loss``
on that batch, what its sequential engine and pretrain mode train), or with
``per_sequence`` routes each sequence alone with its own aux
(``sequence_losses``: ``model.loss`` of each one-sequence batch, what the
reference's batched engine trains).  For a model with experts these are two
functions, in the reference as here; without experts they are one.
``remat`` is a memory policy, not semantics: each layer is recomputed in
the backward pass (``torch.utils.checkpoint``) where the reference
checkpoints each scanned cycle and each rest block; each loss chunk is
recomputed either way, as in the reference.  Gradients flow through every block kind: autograd carries
them through the mLSTM's chunkwise form and the RG-LRU's scan, and the
sLSTM's loop carries its derivatives written out (``ssm._SLSTMSequence``);
the in-place decode steps stay off training.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import random as prng
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, MLSTM, RGLRU, SLSTM, ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, rglru, ssm
from repro_torch.models.layers import apply_mlp, apply_norm, embed_init, init_mlp, init_norm

_ATTN_KINDS = (ATTN_GLOBAL, ATTN_LOCAL)
_KINDS = _ATTN_KINDS + (RGLRU, MLSTM, SLSTM)
# float64: a referee's weights and products (norms, attention, the router
# and the cross-entropy stay fp32, as in every dtype)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}

Params = Dict[str, object]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice of the port lacks."""
    later = []
    kinds = sorted(set(cfg.layer_kinds()) - set(_KINDS))
    if kinds:
        later.append(f"block kinds {kinds}")
    if cfg.is_encdec:
        later.append("the encoder and cross-attention")
    if cfg.image_tokens:
        later.append("image tokens")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} wait for a later slice of the port; this one runs "
            f"the dense attention-only and mixture-of-experts architectures, the RG-LRU hybrid "
            f"and xLSTM"
        )


# ===========================================================================
# blocks
# ===========================================================================
def _is_local(kind: str) -> bool:
    """Whether a block is local attention; raises for the block kinds this
    slice lacks."""
    if kind not in _KINDS:
        raise NotImplementedError(f"block kind {kind!r} waits for a later slice of the port")
    return kind == ATTN_LOCAL


def _has_mlp(kind: str, cfg: ArchConfig) -> bool:
    return kind in _ATTN_KINDS and cfg.d_ff > 0


def init_block(key: np.ndarray, kind: str, cfg: ArchConfig, dtype: torch.dtype,
               device: torch.device) -> Dict:
    """The reference's ``init_block``: of its five subkeys the mixer draws
    from the first and the MLP from the third."""
    _is_local(kind)
    r1, _, r3, _, _ = prng.split(key, 5)
    if kind == RGLRU:
        mixer = rglru.init_rglru(r1, cfg, dtype, device)
    elif kind == MLSTM:
        mixer = ssm.init_mlstm(r1, cfg, dtype, device)
    elif kind == SLSTM:
        mixer = ssm.init_slstm(r1, cfg, dtype, device)
    else:
        mixer = attn.init_attention(r1, cfg, dtype, device)
    p: Dict = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, device), "mixer": mixer}
    if _has_mlp(kind, cfg):
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
        if cfg.moe is not None:
            p["mlp"] = moe.init_moe(r3, cfg, dtype, device)
        else:
            p["mlp"] = init_mlp(r3, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device)
    return p


def layer_key(r_dec: np.ndarray, i: int, cfg: ArchConfig) -> np.ndarray:
    """Flat layer i's key: the reference folds ``pos·1000 + cycle`` into the
    decoder's key for the scanned cycles and ``99_000 + r`` for rest layer r."""
    plen = len(cfg.pattern)
    nc = cfg.num_layers // plen
    if i < nc * plen:
        return prng.fold_in(r_dec, (i % plen) * 1000 + i // plen)
    return prng.fold_in(r_dec, 99_000 + i - nc * plen)


def apply_block_train(params: Dict, kind: str, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ArchConfig, moe_capacity_factor: Optional[float],
                      moe_group_size: Optional[int], per_sequence: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-norm residual block over whole sequences (causal): (x, the MoE
    MLP's aux loss, or None without experts).  An MoE MLP routes with
    ``TransformerLM``'s ``moe_capacity_factor`` and ``moe_group_size``, the
    batch together (aux a scalar) or each sequence alone (``per_sequence``:
    aux (B,))."""
    h = apply_norm(cfg.norm, params["norm1"], x)
    if kind == RGLRU:
        x = x + rglru.apply_rglru(params["mixer"], h, cfg)
    elif kind == MLSTM:
        x = x + ssm.apply_mlstm(params["mixer"], h, cfg)
    elif kind == SLSTM:
        x = x + ssm.apply_slstm(params["mixer"], h, cfg)
    else:
        x = x + attn.attention_block(params["mixer"], h, positions, cfg, local=_is_local(kind))
    aux = None
    if "mlp" in params:
        h2 = apply_norm(cfg.norm, params["norm2"], x)
        if cfg.moe is not None:
            mlp_out, aux = moe.apply_moe(params["mlp"], h2, cfg,
                                         capacity_factor=moe_capacity_factor,
                                         group_size=moe_group_size, per_sequence=per_sequence)
        else:
            mlp_out = apply_mlp(params["mlp"], h2, cfg.act)
        x = x + mlp_out
    return x, aux


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass instead of keeping its
    activations.  No RNG runs inside, so none is saved (and a CUDA graph
    capture reads no generator state)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int, dtype: torch.dtype,
                     device: torch.device) -> Dict:
    if kind == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    if kind == MLSTM:
        return ssm.init_mlstm_cache(cfg, batch, device)
    if kind == SLSTM:
        return ssm.init_slstm_cache(cfg, batch, device)
    length = min(cache_len, cfg.window) if (_is_local(kind) and cfg.window) else cache_len
    return attn.init_kv_cache(cfg, batch, length, dtype, device)


def apply_block_decode(params: Dict, kind: str, x_t: torch.Tensor, cache: Dict, position: int,
                       cfg: ArchConfig, *,
                       length: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """Pre-norm residual block for one token; ``cache`` is updated in place."""
    h = apply_norm(cfg.norm, params["norm1"], x_t)
    if kind == RGLRU:
        mix, cache = rglru.rglru_decode_step(params["mixer"], h, cache, cfg)
    elif kind == MLSTM:
        mix, cache = ssm.mlstm_decode_step(params["mixer"], h, cache, cfg)
    elif kind == SLSTM:
        mix, cache = ssm.slstm_decode_step(params["mixer"], h, cache, cfg)
    else:
        mix, cache = attn.attention_decode_step(params["mixer"], h, cache, position, cfg,
                                                local=_is_local(kind), length=length)
    x_t = x_t + mix
    if "mlp" in params:
        h2 = apply_norm(cfg.norm, params["norm2"], x_t)
        if cfg.moe is not None:                  # drop-free: a token's experts are its own
            x_t = x_t + moe.mix(params["mlp"], h2, cfg, capacity_factor=None,
                                group_size=None)[0]
        else:
            x_t = x_t + apply_mlp(params["mlp"], h2, cfg.act)
    return x_t, cache


# ===========================================================================
# the model
# ===========================================================================
class TransformerLM(nn.Module):
    """The port's decoder LM.  Stateless like the reference's: parameters and
    caches are passed in, so one module serves any number of parameter sets."""

    def __init__(self, cfg: ArchConfig, remat: bool = True, loss_chunk: int = 256,
                 moe_capacity_factor: Optional[float] = 1.25,
                 moe_group_size: Optional[int] = 2048):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.remat = remat
        # sequence-chunk size of the chunked cross-entropy
        self.loss_chunk = loss_chunk
        # MoE routing of full sequences (train, prefill): the expert capacity
        # factor (None: drop-free) and the dispatch group's tokens
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_group_size = moe_group_size

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0, device: DeviceLike = "cuda") -> Params:
        """The reference's ``init(PRNGKey(seed))``, bitwise, drawn on
        ``device``: ``split(PRNGKey(seed), 4)`` gives the embedding's, the
        decoder's, the (unused) encoder's and the unembedding's keys, and
        each layer folds its place into the decoder's (:func:`layer_key`)."""
        cfg, dtype = self.cfg, self.dtype
        dev = resolve_device(device)
        r_emb, r_dec, _, r_un = prng.split(prng.PRNGKey(seed), 4)
        params: Params = {"embed": embed_init(r_emb, cfg.vocab_size, cfg.d_model, dtype, dev)}
        params["layers"] = [init_block(layer_key(r_dec, i, cfg), kind, cfg, dtype, dev)
                            for i, kind in enumerate(cfg.layer_kinds())]
        params["final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init(r_un, cfg.vocab_size, cfg.d_model, dtype,
                                           dev).T.contiguous()
        return params

    def unembed(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return h @ params["unembed"]

    # -- full-sequence forward (train / prefill) -----------------------------
    def hidden_aux(self, params: Params, batch: Dict[str, torch.Tensor],
                   per_sequence: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(final-norm hidden states (B, S, D) of ``batch["tokens"]`` (B, S),
        the layers' summed MoE aux loss, or None for a model without
        experts).  The experts route the batch together and aux is a
        scalar, or with ``per_sequence`` each sequence alone and aux is
        (B,), each sequence's own."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = params["embed"][tokens].to(self.dtype)
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        remat = self.remat and torch.is_grad_enabled()
        route = (self.moe_capacity_factor, self.moe_group_size, per_sequence)
        aux = None
        for kind, layer in zip(cfg.layer_kinds(), params["layers"]):
            if remat:
                h, a = _remat(apply_block_train, layer, kind, h, positions, cfg, *route)
            else:
                h, a = apply_block_train(layer, kind, h, positions, cfg, *route)
            if a is not None:
                aux = a if aux is None else aux + a
        return apply_norm(cfg.norm, params["final_norm"], h), aux

    def hidden(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Final-norm hidden states (B, S, D) of ``batch["tokens"]`` (B, S)."""
        return self.hidden_aux(params, batch)[0]

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V).  Materializes full logits; the training loss
        uses the chunked path instead."""
        return self.unembed(params, self.hidden(params, batch))

    def nll_sums(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) each sequence's summed next-token NLL over its labelled
        positions (labels -1 are not counted): the reference's
        sequence-chunked cross-entropy, summed per sequence.  Each S-chunk's
        logits are fp32; the gold logit is a row gather of the unembedding.
        A model's MoE aux loss is not in it (``loss`` and
        ``sequence_losses`` add it)."""
        return self._nll_sums(params, self.hidden(params, batch), batch["labels"])

    def _nll_sums(self, params: Params, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        labels = labels.long()
        b, s, _ = h.shape
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        chunk = min(self.loss_chunk, s)
        pad = (-s) % chunk
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        remat = torch.is_grad_enabled()
        total = torch.zeros((b,), dtype=torch.float32, device=h.device)
        for c in range(0, s + pad, chunk):
            hc, yc = h[:, c:c + chunk], labels[:, c:c + chunk]
            total = total + (_remat(_chunk_nll, hc, yc, w) if remat else _chunk_nll(hc, yc, w))
        return total

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token NLL: the summed NLL over ``b·s`` (the unpadded
        sequence length), plus the MoE aux loss of a model with experts."""
        b, s = batch["tokens"].shape
        h, aux = self.hidden_aux(params, batch)
        nll = torch.sum(self._nll_sums(params, h, batch["labels"])) / (b * s)
        return nll if aux is None else nll + aux

    def sequence_losses(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B,) each sequence's ``loss`` alone: its summed NLL over ``s``,
        plus, for a model with experts, its own aux with the sequence routed
        alone (the reference's ``model.loss`` of that one-sequence batch)."""
        s = batch["tokens"].shape[1]
        h, aux = self.hidden_aux(params, batch, per_sequence=True)
        nll = self._nll_sums(params, h, batch["labels"]) / s
        return nll if aux is None else nll + aux

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, device: DeviceLike = "cuda") -> List[Dict]:
        dev = resolve_device(device)
        return [init_block_cache(kind, self.cfg, batch, cache_len, self.dtype, dev)
                for kind in self.cfg.layer_kinds()]

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: List[Dict],
                    position: int) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens (B, 1) at ``position`` (a host int) → logits (B, 1, V).

        The caches are updated in place and returned.  The step makes its
        (B,) lengths on the device from ``position`` and never waits on the
        device itself."""
        cfg = self.cfg
        x = params["embed"][tokens].to(self.dtype)
        length = torch.full((tokens.shape[0],), position + 1, dtype=torch.int32,
                            device=tokens.device)
        for i, (kind, layer) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
            x, cache[i] = apply_block_decode(layer, kind, x, cache[i], position, cfg,
                                             length=length)
        x = apply_norm(cfg.norm, params["final_norm"], x)
        return self.unembed(params, x), cache


def _chunk_nll(hc: torch.Tensor, yc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,) summed NLL of one sequence chunk: hc (B, C, D), labels yc (B, C),
    unembedding w (D, V)."""
    logits = (hc @ w).float()                                       # (B, C, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold_rows = w.T[torch.clamp(yc, 0, w.shape[1] - 1)]              # (B, C, D)
    gold = torch.sum(hc.float() * gold_rows.float(), dim=-1)
    valid = (yc >= 0).float()
    return torch.sum((logz - gold) * valid, dim=-1)
