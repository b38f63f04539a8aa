"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M].

Llama-architecture small model: 30L, d_model 576, 9 heads (GQA kv=3,
head_dim 64), d_ff 1536 (SwiGLU), vocab 49152, tied embeddings.
"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm_135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    act="silu",
    tie_embeddings=True,
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, dtype="float32", remat=False)
