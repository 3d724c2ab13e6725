"""minitron-4b — dense, pruned nemotron geometry.

[arXiv:2407.14679]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
Nemotron-4 uses a non-gated squared-ReLU MLP; preserved here as act="relu2".
"""
from repro_torch.configs.base import ATTN_GLOBAL, ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=9216,
        vocab_size=256_000,
        pattern=(ATTN_GLOBAL,),
        norm="rmsnorm",
        act="relu2",
        gated_mlp=False,
        rope_theta=10_000.0,
        max_position=4096,
        citation="arXiv:2407.14679 (Minitron: pruned Nemotron-4, squared-ReLU MLP)",
    )
