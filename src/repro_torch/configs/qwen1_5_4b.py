"""qwen1.5-4b — dense, QKV bias, GQA kv=20.

[hf:Qwen/Qwen1.5-0.5B] family scaled per assignment:
40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        vocab_size=151_936,
        pattern=(ATTN_GLOBAL,),
        qkv_bias=True,
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=1_000_000.0,
        max_position=32_768,
        citation="hf:Qwen/Qwen1.5-0.5B (Qwen1.5 family geometry, 4B point)",
    )
