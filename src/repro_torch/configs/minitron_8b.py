"""Minitron-8B (pruned Nemotron-4) [arXiv:2407.14679].

Dense decoder: 32L, d_model 4096, 32 heads (GQA kv=8, head_dim 128),
d_ff 16384 with squared-ReLU (no GLU, Nemotron-style), vocab 256000.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron_8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    act="relu_sq",
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32", remat=False)
