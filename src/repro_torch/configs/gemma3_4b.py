"""gemma3-4b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt] family geometry, 4B point per assignment:
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144; sliding window 1024
on local layers, every 6th layer global.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        d_ff=10_240,
        vocab_size=262_144,
        head_dim=256,
        # 5 local then 1 global, applied cyclically (gemma-3 5:1 ratio)
        pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
        window=1024,
        qkv_bias=False,
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        max_position=131_072,
        citation="hf:google/gemma-3-1b-pt (gemma-3 5:1 local:global, 128k)",
    )
