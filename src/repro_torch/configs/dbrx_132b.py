"""dbrx-132b — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts, top-4 routing.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ArchConfig, MoEConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10_752,
        vocab_size=100_352,
        pattern=(ATTN_GLOBAL,),
        moe=MoEConfig(num_experts=16, top_k=4),
        qkv_bias=False,
        norm="layernorm",
        act="silu",
        gated_mlp=True,
        rope_theta=500_000.0,
        max_position=32_768,
        citation="hf:databricks/dbrx-base (16e top-4 fine-grained MoE)",
    )
