"""GLM-4-9B [hf:THUDM/glm-4-9b].

Dense decoder: 40L, d_model 4096, 32 heads (GQA kv=2, head_dim 128),
d_ff 13696 (SwiGLU), vocab 151552, RoPE.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4_9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    act="silu",
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32", remat=False)
