"""deepseek-7b — dense llama-style architecture.

[arXiv:2401.02954] DeepSeek LLM: 30L d_model=4096 32H (kv=32) d_ff=11008
vocab=102400.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11_008,
        vocab_size=102_400,
        pattern=(ATTN_GLOBAL,),
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        rope_theta=10_000.0,
        max_position=4096,
        citation="arXiv:2401.02954 (DeepSeek LLM 7B, llama-arch)",
    )
