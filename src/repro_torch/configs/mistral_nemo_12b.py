"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder: 40L, d_model 5120, 32 q heads (head_dim 128, GQA kv=8),
d_ff 14336 (SwiGLU), vocab 131072, 128k context (rope theta 1M).
Full attention -> long_500k skipped (DESIGN.md §4).
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral_nemo_12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    act="silu",
    rope_theta=1_000_000.0,
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32", remat=False)
