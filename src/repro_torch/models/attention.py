"""Attention: GQA with blockwise (flash-style) softmax, decode paths, and MLA.

Port of ``repro.models.attention`` as plain PyTorch ops (the reference
computes attention outside any Pallas kernel).
``blockwise_attention`` walks q chunks and, inside each, KV chunks with a
running max and denominator in fp32, as the reference's two ``lax.scan``
loops do, so live scores stay O(q_chunk x kv_chunk).  Cross-attention
(the reference's ``gqa_forward(kv_override=)``) is ``attend`` of
``query`` over ``memory_kv``: keys and values from a memory through ``wk``
and ``wv``, without rope and without a causal mask.
Multi-head latent attention (MLA, DeepSeek-V2) compresses keys and values
into a latent ``c_kv`` (B, S, kv_lora_rank) plus one shared roped key
``k_rope`` (B, S, qk_rope_dim): the prefill expands the latent per head
and runs ``blockwise_attention`` (Dk = nope + rope, Dv = v_head_dim, KH =
H); the decode step keeps the cache latent and absorbs ``W_uk`` into the
query and ``W_uv`` after the softmax, in fp32.

Under a sharding policy q, k and v are DTensors.  ``blockwise_attention``
and ``decode_attention`` then run on each rank's local shards
(``_on_local_shards``): ``_gqa_layout`` first keeps only the three's
common batch shards and the head shards that KH divides, and makes every
other dim whole (a sequence shard, a head shard that straddles KV groups),
so that the attention of a shard needs nothing from another rank.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import is_dtensor
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor

NEG_INF = -1e30


def _gqa_layout(q: Tensor, k: Tensor, v: Tensor) -> list:
    """Placements for DTensors q, k, v: on each mesh axis, the batch shard
    (dim 0) or the head shard (dim 2, where the axis divides KH) that all
    three share, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, kh = q.device_mesh, k.shape[2]
    layout = []
    for i in range(mesh.ndim):
        pl = {t.placements[i] for t in (q, k, v)}
        same = pl.pop() if len(pl) == 1 else None
        if same == Shard(0) or (same == Shard(2) and kh % mesh.size(i) == 0):
            layout.append(same)
        else:
            layout.append(Replicate())
    return layout


def _on_local_shards(fn, q: Tensor, k: Tensor, v: Tensor, **kw) -> Tensor:
    """``fn(q, k, v, **kw)`` on each rank's shards of q, k, v laid out by
    ``_gqa_layout`` (redistributed to it first); the output (B, Sq, H, Dv)
    takes the same placements."""
    from torch.distributed.tensor.experimental import local_map
    layout = _gqa_layout(q, k, v)
    return local_map(functools.partial(fn, **kw), out_placements=layout,
                     in_placements=(layout, layout, layout),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        q_offset: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024) -> Tensor:
    """q: (B,Sq,H,Dk), k: (B,Skv,KH,Dk), v: (B,Skv,KH,Dv); H = KH*G (GQA).

    Returns (B,Sq,H,Dv).  fp32 softmax statistics; O(chunk^2) live scores.
    """
    if is_dtensor(q):
        return _on_local_shards(blockwise_attention, q, k, v, causal=causal,
                                window=window, q_offset=q_offset,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
    b, sq, h, dk = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kh
    cq = min(q_chunk, sq)
    ck = min(kv_chunk, skv)
    pad_q = -sq % cq
    pad_k = -skv % ck
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (sq + pad_q) // cq, (skv + pad_k) // ck
    qs = q.reshape(b, nq, cq, kh, g, dk)
    kc = k.reshape(b, nk, ck, kh, dk)
    vc = v.reshape(b, nk, ck, kh, dv)
    scale = 1.0 / math.sqrt(dk)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qs[:, qi].float()                              # (B,cq,KH,G,Dk)
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, kh, g, cq), NEG_INF, device=dev)
        l = torch.zeros((b, kh, g, cq), device=dev)
        acc = torch.zeros((b, kh, g, cq, dv), device=dev)
        for kj in range(nk):
            kpos = kj * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb,
                             kc[:, kj].float()) * scale
            mask = (kpos[None, :] < skv).expand(cq, ck)     # kv padding
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vc[:, kj].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # (B,KH,G,cq,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4))             # (B,cq,KH,G,Dv)
    out = torch.stack(outs, 1).reshape(b, nq * cq, h, dv)
    return out[:, :sq].to(q.dtype)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     kv_len: Union[int, Tensor], *,
                     window: Optional[int] = None) -> Tensor:
    """One-token attention over a (possibly partially filled) cache.

    q: (B,1,H,Dk); caches: (B,S,KH,D*); kv_len: the current length.
    """
    if is_dtensor(q):
        return _on_local_shards(decode_attention, q, k_cache, v_cache,
                                kv_len=kv_len, window=window)
    b, _, h, dk = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qv = q.reshape(b, kh, g, dk)
    scores = torch.einsum("bhgd,bkhd->bhgk", qv.float(), k_cache.float())
    scores = scores / math.sqrt(dk)
    pos = torch.arange(s, device=q.device)
    mask = pos < kv_len
    if window is not None:
        mask = mask & (pos > kv_len - 1 - window)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, -1).to(q.dtype)


def init_gqa(generator: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(generator, (d, h * hd), dtype, device=device),
        "wk": dense_init(generator, (d, kh * hd), dtype, device=device),
        "wv": dense_init(generator, (d, kh * hd), dtype, device=device),
        "wo": dense_init(generator, (h * hd, d), dtype, device=device),
    }


def query(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Projected q (B,S,H,hd), without rope."""
    b, s, _ = x.shape
    return (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)


def qkv(p: dict, x: Tensor, positions: Tensor, cfg: ArchConfig
        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Projected q (B,S,H,hd), k and v (B,S,KH,hd), rope on q and k."""
    b, s, _ = x.shape
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    q = query(p, x, cfg)
    k = (x @ p["wk"]).reshape(b, s, kh, hd)
    v = (x @ p["wv"]).reshape(b, s, kh, hd)
    q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def memory_kv(p: dict, memory: Tensor, cfg: ArchConfig
              ) -> Tuple[Tensor, Tensor]:
    """Keys and values (B,M,KH,hd) of a memory (B,M,D), without rope."""
    b, m, _ = memory.shape
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    return ((memory @ p["wk"]).reshape(b, m, kh, hd),
            (memory @ p["wv"]).reshape(b, m, kh, hd))


def attend(p: dict, q: Tensor, k: Tensor, v: Tensor, cfg: ArchConfig, *,
           causal: bool, window: Optional[int] = None) -> Tensor:
    """Blockwise attention of q over (k, v), then the output projection."""
    b, s = q.shape[:2]
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
    return out.reshape(b, s, -1) @ p["wo"]


def gqa_forward(p: dict, x: Tensor, positions: Tensor, cfg: ArchConfig, *,
                window: Optional[int] = None, causal: bool = True) -> Tensor:
    """Full-sequence GQA self-attention."""
    q, k, v = qkv(p, x, positions, cfg)
    return attend(p, q, k, v, cfg, causal=causal, window=window)


def decode_qkv(p: dict, x: Tensor, pos: int, cfg: ArchConfig
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """q, k, v of one token at position ``pos``.  x: (B,1,D)."""
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    return qkv(p, x, positions, cfg)


def gqa_decode(p: dict, x: Tensor, cache: dict, pos: int, cfg: ArchConfig,
               *, window: Optional[int] = None) -> Tuple[Tensor, dict]:
    """One-token decode.  cache: {k: (B,S,KH,hd), v: ...}; writes at pos."""
    b = x.shape[0]
    q, k, v = decode_qkv(p, x, pos, cfg)
    # dynamic_update_slice clamps the start so the update fits
    at = min(pos, cache["k"].shape[1] - 1)
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    k_cache[:, at:at + 1] = k
    v_cache[:, at:at + 1] = v
    out = decode_attention(q, k_cache, v_cache, pos + 1, window=window)
    y = out.reshape(b, 1, -1) @ p["wo"]
    return y, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2).
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim

    def w(shape):
        return dense_init(generator, shape, dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {"wdq": w((d, m.q_lora_rank)), "q_norm": zeros(m.q_lora_rank),
            "wuq": w((m.q_lora_rank, h * qk)),
            "wdkv": w((d, m.kv_lora_rank)),
            "kv_norm": zeros(m.kv_lora_rank),
            "wuk": w((m.kv_lora_rank, h * m.qk_nope_dim)),
            "wuv": w((m.kv_lora_rank, h * m.v_head_dim)),
            "wkr": w((d, m.qk_rope_dim)), "wo": w((h * m.v_head_dim, d))}


def _mla_q(p: dict, x: Tensor, positions: Tensor, cfg: ArchConfig
           ) -> Tuple[Tensor, Tensor]:
    """q_nope (B,S,H,nope) and the roped q_rope (B,S,H,rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(b, s, cfg.num_heads,
                                m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, rope_lib.apply_rope(q_rope, positions, cfg.rope_theta)


def mla_latent(p: dict, x: Tensor, positions: Tensor, cfg: ArchConfig
               ) -> dict:
    """The decode cache entry of x (B,S,D): the normed latent ``ckv``
    (B,S,kv_lora_rank) and the shared roped key ``kr`` (B,S,qk_rope_dim)."""
    return {"ckv": rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps),
            "kr": rope_lib.apply_rope(x @ p["wkr"], positions,
                                      cfg.rope_theta)}


def mla_prefill(p: dict, x: Tensor, positions: Tensor, cfg: ArchConfig
                ) -> Tuple[Tensor, dict]:
    """Full-sequence MLA (the latent expanded per head, causal blockwise
    attention) and its ``mla_latent`` cache entry."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    lat = mla_latent(p, x, positions, cfg)
    k_nope = (lat["ckv"] @ p["wuk"]).reshape(b, s, h, m.qk_nope_dim)
    v = (lat["ckv"] @ p["wuv"]).reshape(b, s, h, m.v_head_dim)
    k_rope = lat["kr"][:, :, None, :].expand(b, s, h, m.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    return attend(p, q, k, v, cfg, causal=True), lat


def mla_forward(p: dict, x: Tensor, positions: Tensor, cfg: ArchConfig
                ) -> Tensor:
    """Training/prefill MLA: expand the latent per head, flash attention."""
    return mla_prefill(p, x, positions, cfg)[0]


def mla_decode(p: dict, x: Tensor, cache: dict, pos: int, cfg: ArchConfig
               ) -> Tuple[Tensor, dict]:
    """Absorbed-matmul decode: the cache stays in latent space (r + rope).

    cache: {ckv: (B,S,r), kr: (B,S,dr)}; writes at pos (clamped as
    ``dynamic_update_slice`` clamps it) and attends to [0, pos]."""
    m = cfg.mla
    b = x.shape[0]
    h, r = cfg.num_heads, m.kv_lora_rank
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)            # (B,1,H,*)
    lat = mla_latent(p, x, positions, cfg)
    at = min(pos, cache["ckv"].shape[1] - 1)
    new = {}
    for key in ("ckv", "kr"):
        new[key] = cache[key].clone()
        new[key][:, at:at + 1] = lat[key]
    ckv = new["ckv"].float()
    # absorb W_uk into q: q_eff (B,H,r)
    wuk = p["wuk"].reshape(r, h, m.qk_nope_dim).float()
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wuk)
    s_lat = torch.einsum("bhr,bsr->bhs", q_eff, ckv)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                          new["kr"].float())
    scores = (s_lat + s_rope) / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    mask = torch.arange(ckv.shape[1], device=x.device) < pos + 1
    pattn = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pattn, ckv)
    wuv = p["wuv"].reshape(r, h, m.v_head_dim).float()
    out = torch.einsum("bhr,rhd->bhd", ctx, wuv)
    y = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]
    return y, new
