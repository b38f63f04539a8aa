"""Llama-3.2-Vision-90B (backbone) [hf:meta-llama/Llama-3.2-11B-Vision scaled].

100 transformer layers, every 5th a gated cross-attention layer over
precomputed vision patch embeddings (the modality frontend is a STUB per
the brief: ``input_specs`` provides (B, 1600, d_model) patch embeddings).
d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 28672, vocab 128256.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama32_vision_90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    act="silu",
    rope_theta=500_000.0,
    cross_attn_every=5,
    num_vision_tokens=1600,
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, num_vision_tokens=8,
        dtype="float32", remat=False)
