"""xlstm-1.3b — SSM-family: sLSTM + mLSTM residual blocks.

[arXiv:2405.04517] xLSTM. Assignment geometry: 48L d_model=2048 4H d_ff=0
vocab=50304.  d_ff=0: xLSTM blocks carry their own up-projection (2x for
mLSTM, 1x + gates for sLSTM).  Ratio follows the paper's xLSTM[7:1]:
one sLSTM block per 8 layers, the rest mLSTM.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        pattern=(MLSTM,) * 7 + (SLSTM,),
        norm="layernorm",
        act="gelu",
        gated_mlp=False,
        max_position=524_288,  # recurrent state => unbounded context
        citation="arXiv:2405.04517 (xLSTM, [7:1] mLSTM:sLSTM)",
    )
