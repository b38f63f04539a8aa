"""Architecture configuration covering the full assigned pool.

Port of ``repro.models.config`` (pure Python, copied so that the port
imports nothing of the JAX package).  One dataclass describes dense / MoE /
MLA / hybrid-recurrent / xLSTM / encoder-decoder / cross-attention-VLM
stacks; family-specific fields are None/0 when unused.  Configs instantiate
in ``repro_torch.configs.<id>``.  ``remat`` and ``scan_unroll`` shape the
JAX package's compiled graph and have no meaning in the port's eager loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden
    num_shared: int = 0           # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    group_size: int = 512         # GShard dispatch group (tokens)
    first_dense_layers: int = 0   # leading layers with dense FFN


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    kind: str = "rg_lru"          # rg_lru | xlstm_m | xlstm_s
    conv_width: int = 4           # temporal FuSeConv front-end width
    width_factor: float = 1.0     # recurrent branch width vs d_model
    heads: int = 0                # xLSTM heads (0 -> use cfg.num_heads)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # attention
    attn_kind: str = "gqa"        # gqa | mla
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # local attention window
    mla: Optional[MLAConfig] = None

    # FFN
    act: str = "silu"             # silu (GLU), gelu (GLU), relu
    moe: Optional[MoEConfig] = None

    # heterogeneous stacks: repeating block pattern, e.g. ("rec","rec","attn")
    block_pattern: Optional[Tuple[str, ...]] = None
    recurrent: Optional[RecurrentConfig] = None

    # VLM cross-attention (cross layer every `cross_attn_every`-th position)
    cross_attn_every: int = 0
    num_vision_tokens: int = 0

    # encoder-decoder (audio): encoder self-attn layers + source positions
    encoder_layers: int = 0
    encoder_seq: int = 0

    # norms / embeddings
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    # blockwise-attention chunk sizes (smaller = less live memory;
    # probes raise them so chunk-loop unrolling stays tractable)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # Unroll scan-over-layers at lowering time.  Used by the dry-run so
    # compiled.cost_analysis() / HLO collective parsing see every layer
    # (XLA's cost analysis counts a while body once — measured, DESIGN.md §6).
    scan_unroll: bool = False
    # which of the four assigned shapes apply (DESIGN.md §4)
    supports_decode: bool = True
    supports_long: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length == num_layers."""
        if self.block_pattern is None:
            if self.cross_attn_every:
                pat = []
                for i in range(self.num_layers):
                    pat.append("cross" if (i % self.cross_attn_every ==
                                           self.cross_attn_every - 1)
                               else "attn")
                return tuple(pat)
            return ("attn",) * self.num_layers
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_kind == "mla" and self.mla is not None:
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            return (d * m.q_lora_rank +
                    m.q_lora_rank * self.num_heads * qk +
                    d * (m.kv_lora_rank + m.qk_rope_dim) +
                    m.kv_lora_rank * self.num_heads *
                    (m.qk_nope_dim + m.v_head_dim) +
                    self.num_heads * m.v_head_dim * d)
        return (d * self.num_heads * self.head_dim * 2 +
                d * self.num_kv_heads * self.head_dim * 2)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.layer_pattern:
            if kind in ("attn", "cross"):
                total += self._attn_params() + self._ffn_params()
            elif kind == "dec":
                total += 2 * self._attn_params() + self._ffn_params()
            elif kind == "rec" and self.recurrent is not None:
                w = int(d * self.recurrent.width_factor)
                nb = self.recurrent.heads or 16
                total += (3 * d * w + w * self.recurrent.conv_width +
                          2 * w * w // nb + self._ffn_params())
            elif kind == "xm":
                di = 2 * d
                total += d * 2 * di + 3 * di * di + di * d + \
                    di * self.recurrent.conv_width
            elif kind == "xs":
                h = self.recurrent.heads or self.num_heads
                total += 4 * d * d + 4 * d * (d // h) + 3 * d * (4 * d // 3)
        # encoder stack (enc-dec archs)
        total += self.encoder_layers * (self._attn_params() +
                                        self._ffn_params())
        return total

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            e = self.moe
            per = 3 * d * e.d_expert
            return per * (e.num_experts + e.num_shared) + d * e.num_experts
        mult = 3 if self.act in ("silu", "gelu") else 2
        return mult * d * self.d_ff

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared only) — for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        total = self.param_count()
        all_experts = 3 * d * e.d_expert * e.num_experts * \
            len([k for k in self.layer_pattern if k in ("attn", "cross")])
        active = 3 * d * e.d_expert * e.top_k * \
            len([k for k in self.layer_pattern if k in ("attn", "cross")])
        return total - all_experts + active
