"""Qwen3-MoE-235B-A22B (scaled from hf:Qwen/Qwen3-30B-A3B family).

MoE decoder: 94L, d_model 4096, 64 heads (GQA kv=4, head_dim 128),
128 experts top-8, d_expert 1536, vocab 151936.
"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    act="silu",
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                  capacity_factor=1.25, group_size=512),
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64,
                      capacity_factor=1.25, group_size=64),
        dtype="float32", remat=False)
