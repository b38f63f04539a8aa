"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

Hybrid 2:1 recurrent:attention — 26 blocks in a (rec, rec, attn) pattern
(24 in 8 full superblocks + 2 trailing rec), d_model 2560, attention: 10
heads, head_dim 256, MQA (kv=1), sliding window 2048; RG-LRU width 2560
with width-4 temporal FuSeConv front-end; GeGLU d_ff 7680; vocab 256000;
tied embeddings; final logit softcap 30.  Sub-quadratic -> runs long_500k.

This is the arch where the paper's operator is first-class: the temporal
depthwise conv is a bank of independent 1-D convolutions (FuSeConv) and
executes via repro_torch.core.fuseconv / kernels.fuse1d (DESIGN.md §4).
"""
import dataclasses

from repro_torch.models.config import ArchConfig, RecurrentConfig

CONFIG = ArchConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    act="gelu",
    block_pattern=("rec", "rec", "attn"),
    recurrent=RecurrentConfig(kind="rg_lru", conv_width=4, width_factor=1.0,
                              heads=10),
    sliding_window=2048,
    tie_embeddings=True,
    logit_softcap=30.0,
    supports_long=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=2, num_kv_heads=1,
        head_dim=32, d_ff=128, vocab_size=256, sliding_window=16,
        recurrent=RecurrentConfig(kind="rg_lru", conv_width=4,
                                  width_factor=1.0, heads=2),
        dtype="float32", remat=False)
