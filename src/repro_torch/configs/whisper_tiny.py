"""Whisper-tiny [arXiv:2212.04356].

Encoder-decoder: 4 encoder + 4 decoder layers, d_model 384, 6 heads
(head_dim 64), d_ff 1536 (plain GELU MLP), vocab 51865.  The conv/mel
frontend is a STUB (``input_specs`` provides precomputed frame embeddings,
1500 source positions); an optional FuSe-factorized conv stem is shipped in
``repro_torch.core.fuseconv`` as a demonstration (DESIGN.md §4).  Decode shapes
exercise the decoder with the encoder memory attached; 32k decode exceeds
the arch's trained 448 positions and is a compile-shape exercise only.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper_tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    act="gelu_plain",
    tie_embeddings=True,
    block_pattern=("dec",),
    encoder_layers=4,
    encoder_seq=1500,
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, encoder_layers=2,
        encoder_seq=16, dtype="float32", remat=False)
