"""xLSTM-125M [arXiv:2405.04517].

12 blocks, d_model 768, 4 heads, no separate FFN (d_ff=0): mLSTM blocks
(matrix memory, exp gating, width-4 causal FuSeConv front-end) with every
4th block an sLSTM (scalar memory + its own gated FFN) — an [m,m,m,s]
pattern approximating the paper's 7:1 at this depth.  Linear-time
recurrence -> runs long_500k.
"""
import dataclasses

from repro_torch.models.config import ArchConfig, RecurrentConfig

CONFIG = ArchConfig(
    name="xlstm_125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    act="gelu",
    block_pattern=("xm", "xm", "xm", "xs"),
    recurrent=RecurrentConfig(kind="xlstm", conv_width=4, heads=4),
    tie_embeddings=True,
    supports_long=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        head_dim=32, vocab_size=256,
        recurrent=RecurrentConfig(kind="xlstm", conv_width=4, heads=2),
        dtype="float32", remat=False)
