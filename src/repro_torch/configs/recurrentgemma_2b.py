"""recurrentgemma-2b — hybrid: RG-LRU recurrent blocks + local attention, 2:1.

[arXiv:2402.19427] Griffin/RecurrentGemma. Assignment geometry: 26L
d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000; pattern = 2 RG-LRU
residual blocks then 1 local-attention block (window 2048).
"""
from repro_torch.configs.base import ATTN_LOCAL, RGLRU, ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        d_ff=7680,
        vocab_size=256_000,
        head_dim=256,
        pattern=(RGLRU, RGLRU, ATTN_LOCAL),
        window=2048,
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        tie_embeddings=True,
        rope_theta=10_000.0,
        max_position=524_288,  # recurrent+local => unbounded
        citation="arXiv:2402.19427 (Griffin: RG-LRU + local attn 1:2)",
    )
