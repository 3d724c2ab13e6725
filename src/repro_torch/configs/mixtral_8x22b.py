"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] Mixtral family; assignment geometry: 56L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=32768, 8 experts top-2, SWA(4096).
"""
from repro_torch.configs.base import ATTN_LOCAL, ArchConfig, MoEConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16_384,
        vocab_size=32_768,
        pattern=(ATTN_LOCAL,),
        window=4096,
        moe=MoEConfig(num_experts=8, top_k=2),
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=1_000_000.0,
        max_position=65_536,
        citation="arXiv:2401.04088 (Mixtral, 8e top-2, SWA)",
    )
