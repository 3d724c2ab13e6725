"""Configuration dataclasses of the port, copied from the reference's
``src/repro/configs/base.py`` (the FL hyper-parameters stay with ``fl``).

Every architecture is an :class:`ArchConfig`; every input shape a
:class:`ShapeConfig`.  Configs are plain frozen dataclasses, so they hash and
compare by value.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used to compose per-layer patterns.
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "attn_global"      # full causal attention
ATTN_LOCAL = "attn_local"        # sliding-window causal attention
ATTN_CROSS = "attn_cross"        # encoder-decoder cross attention (whisper)
MLSTM = "mlstm"                  # xLSTM matrix-memory block (parallel form)
SLSTM = "slstm"                  # xLSTM scalar-memory block (recurrent scan)
RGLRU = "rglru"                  # RG-LRU recurrent block (Griffin/recurrentgemma)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config."""

    num_experts: int
    top_k: int
    # load-balance auxiliary loss weight (Switch-style)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture description.

    ``pattern`` is the repeating unit of block kinds; the full model applies it
    cyclically over ``num_layers`` (e.g. gemma3's 5 local : 1 global uses a
    6-entry pattern).  ``d_ff == 0`` means the block family has no separate MLP
    (xLSTM blocks carry their own up-projection).
    """

    name: str
    family: str                      # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    window: int = 0                  # sliding window for ATTN_LOCAL blocks
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu | geglu (gated handled via gated_mlp)
    gated_mlp: bool = True           # llama-style SwiGLU MLP
    rope_theta: float = 10_000.0
    max_position: int = 131_072
    # encoder-decoder (whisper): number of encoder layers; frontend is stubbed.
    encoder_layers: int = 0
    encoder_frames: int = 1500       # whisper: 30 s audio -> 1500 frames
    # VLM: number of prepended image-patch embedding tokens (frontend stubbed).
    image_tokens: int = 0
    # citation of the source paper / model card for the exact geometry
    citation: str = ""
    # dtype of params/activations for the production dry-run
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def block_kind(self, layer_idx: int) -> str:
        return self.pattern[layer_idx % len(self.pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.num_layers))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + norms)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        h, kv = self.num_heads, self.num_kv_heads
        total = v * d                         # embedding
        if not self.tie_embeddings:
            total += v * d                    # unembedding
        for kind in self.layer_kinds():
            total += self._block_params(kind, d, f, h, kv, hd)
        total += d                            # final norm
        if self.is_encdec:
            for _ in range(self.encoder_layers):
                total += self._block_params(ATTN_GLOBAL, d, f, h, h, hd)
            total += d
        return total

    def _block_params(self, kind: str, d: int, f: int, h: int, kv: int, hd: int) -> int:
        n = 2 * d  # two norms per block (pre-attn/pre-mlp or equivalents)
        if kind in (ATTN_GLOBAL, ATTN_LOCAL, ATTN_CROSS):
            n += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
            if self.qkv_bias:
                n += h * hd + 2 * kv * hd
        elif kind == MLSTM:
            # q,k,v,o projections at 2x inner dim + gates
            inner = 2 * d
            n += 3 * d * inner + inner * d + 3 * d
        elif kind == SLSTM:
            inner = d
            n += 4 * d * inner + 4 * inner + inner * d
        elif kind == RGLRU:
            inner = 3 * d // 2  # griffin uses 1.5x expansion
            n += 2 * d * inner + inner * d + 2 * inner + 4 * inner
        if kind != MLSTM and kind != SLSTM and f > 0:
            per_expert = (3 if self.gated_mlp else 2) * d * f
            if self.moe is not None:
                n += self.moe.num_experts * per_expert + d * self.moe.num_experts
            else:
                n += per_expert
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.gated_mlp else 2) * d * f
        inactive = (self.moe.num_experts - self.moe.top_k) * per_expert
        return self.param_count() - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """Assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
