"""Config registry of the port: ``get_arch(name)``, ``list_archs()`` and
``reduce_config``, copied from the reference's ``src/repro/configs``.

The registry holds the architectures whose blocks the port has: the dense
attention-only ones (global and sliding-window attention with a dense MLP),
the hybrid recurrentgemma-2b (RG-LRU blocks beside local attention),
xlstm-1.3b (mLSTM and sLSTM blocks) and the mixture-of-experts
mixtral-8x22b and dbrx-132b.
Every other architecture of the reference raises ``KeyError`` until the
slice that ports its blocks.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.configs.base import ArchConfig, MoEConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES, get_shape

_ARCH_MODULES = {
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
}

# the reference's other architectures and the blocks they wait for
_LATER = {
    "phi-3-vision-4.2b": "image tokens",
    "whisper-medium": "the encoder and cross-attention",
}


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_arch(name: str, *, reduced: bool = False) -> ArchConfig:
    if name in _LATER:
        raise KeyError(
            f"arch {name!r} needs {_LATER[name]}, which waits for a later slice of the port; "
            f"ported: {list_archs()}"
        )
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    cfg = importlib.import_module(_ARCH_MODULES[name]).make_config()
    if reduced:
        cfg = reduce_config(cfg)
    return cfg


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to a CPU-smoke-testable variant of the same family."""
    shrink = max(1, cfg.d_model // 256)
    d_model = max(128, cfg.d_model // shrink)
    # keep the head structure's *ratio*: shrink heads to <=4, keep GQA grouping
    ratio = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    num_heads = min(4, cfg.num_heads)
    num_kv_heads = max(1, num_heads // min(ratio, num_heads))
    head_dim = d_model // num_heads
    # two layers: take the first two entries of the *cyclic* pattern so both
    # block kinds of hybrid archs are exercised where possible
    num_layers = min(2, cfg.num_layers)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            num_experts=min(4, cfg.moe.num_experts),
            top_k=min(2, cfg.moe.top_k),
            aux_loss_weight=cfg.moe.aux_loss_weight,
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else max(256, cfg.d_ff // shrink),
        vocab_size=min(1024, cfg.vocab_size),
        window=min(64, cfg.window) if cfg.window else 0,
        moe=moe,
        encoder_layers=min(2, cfg.encoder_layers),
        encoder_frames=min(16, cfg.encoder_frames),
        image_tokens=min(8, cfg.image_tokens),
        max_position=4096,
    )


__all__ = [
    "ArchConfig",
    "MoEConfig",
    "ShapeConfig",
    "SHAPES",
    "get_shape",
    "get_arch",
    "list_archs",
    "reduce_config",
]
