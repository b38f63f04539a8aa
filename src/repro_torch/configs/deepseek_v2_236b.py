"""DeepSeek-V2-236B [arXiv:2405.04434].

MoE decoder with Multi-head Latent Attention: 60L, d_model 5120, 128 heads,
MLA (kv_lora 512, q_lora 1536, qk nope/rope 128/64, v 128); first layer
dense FFN (d_ff 12288), then 160 routed experts top-6 + 2 shared experts,
d_expert 1536; vocab 102400.  Decode keeps the cache in latent space
(absorbed matmuls) and shards it along sequence (DESIGN.md §5).
"""
import dataclasses

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek_v2_236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,
    vocab_size=102_400,
    act="silu",
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                  capacity_factor=1.25, group_size=512,
                  first_dense_layers=1),
    supports_long=False,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=1,
                      capacity_factor=1.25, group_size=64,
                      first_dense_layers=1),
        dtype="float32", remat=False)
