"""Model stack: heterogeneous layer patterns grouped into superblocks.

Port of ``repro.models.stack``.  The per-layer pattern from
``ArchConfig.layer_pattern`` is grouped into repeating *superblocks* (e.g.
RecurrentGemma's ("rec","rec","attn")); each group's parameters are
stacked on a leading axis, as in the reference, and the model walks that
axis in a Python loop where the reference scans.  Layer kinds:

  attn   causal self-attention (GQA or MLA) + FFN (dense or MoE)
  cross  cross-attention over a memory, tanh-gated (VLM-style) + FFN
  dec    decoder layer: self-attention, cross-attention, FFN (enc-dec)
  enc    non-causal self-attention + FFN (encoder; MLA stays causal, as in
         the reference)
  rec    RG-LRU recurrent block + FFN
  xm/xs  xLSTM mLSTM / sLSTM blocks (self-contained)

A segment's ``use_moe`` puts the MoE FFN in every FFN of its layers, and
``cfg.attn_kind == "mla"`` puts MLA in ``attn`` and ``enc`` (whose decode
cache is then the latent ``{"ckv", "kr"}``).  ``ctx`` carries
``positions``, ``window``, the ``backend`` that picks the temporal conv's
path and, for ``cross`` and ``dec``, the ``memory`` (B, M, D) and its
length ``memory_len``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.common import rms_norm
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor

KINDS = ("attn", "cross", "dec", "enc", "rec", "xm", "xs")


def check_ported(kind: str, cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a layer kind the stack does not know."""
    if kind not in KINDS:
        raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")


def _mla(cfg: ArchConfig, kind: str) -> bool:
    return kind in ("attn", "enc") and cfg.attn_kind == "mla"


# ---------------------------------------------------------------------------
# Segments: (kinds-per-superblock, repeat count, use_moe flag).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: Tuple[str, ...]
    repeats: int
    use_moe: bool


def plan_segments(cfg: ArchConfig) -> List[Segment]:
    pattern = list(cfg.layer_pattern)
    segs: List[Segment] = []
    start = 0
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        k = cfg.moe.first_dense_layers
        segs.append(Segment(tuple(pattern[:k]), 1, False))
        start = k
    rest = pattern[start:]
    if not rest:
        return segs
    # find the shortest repeating unit of the remaining pattern
    unit = None
    for ul in range(1, len(rest) + 1):
        if len(rest) % ul == 0 and rest == rest[:ul] * (len(rest) // ul):
            unit = rest[:ul]
            break
    if unit is not None:
        segs.append(Segment(tuple(unit), len(rest) // len(unit),
                            cfg.moe is not None))
    else:
        # fall back: longest repeating prefix unit + remainder segment
        unit = rest[:1]
        for ul in range(len(rest), 0, -1):
            n_fit = len(rest) // ul
            if n_fit >= 1 and rest[:ul * n_fit] == rest[:ul] * n_fit:
                unit = rest[:ul]
                break
        n_fit = len(rest) // len(unit)
        segs.append(Segment(tuple(unit), n_fit, cfg.moe is not None))
        rem = rest[len(unit) * n_fit:]
        if rem:
            segs.append(Segment(tuple(rem), 1, cfg.moe is not None))
    return segs


# ---------------------------------------------------------------------------
# Per-kind init / forward / decode.
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, kind: str, cfg: ArchConfig,
               use_moe: bool, dtype, device=None) -> dict:
    check_ported(kind, cfg)
    d = cfg.d_model

    def zeros(shape=(d,)):
        return torch.zeros(shape, dtype=dtype, device=device)

    def gqa():
        return attn.init_gqa(generator, cfg, dtype, device)

    def mlp():
        if use_moe:
            return ffn_lib.init_moe(generator, cfg, dtype, device)
        return ffn_lib.init_mlp(generator, d, cfg.d_ff, dtype, cfg.act,
                                device)

    if kind in ("attn", "enc"):
        a = (attn.init_mla(generator, cfg, dtype, device) if _mla(cfg, kind)
             else gqa())
        return {"ln1": zeros(), "attn": a, "ln2": zeros(), "ffn": mlp()}
    if kind == "cross":
        return {"ln1": zeros(), "xattn": gqa(), "gate_attn": zeros(()),
                "ln2": zeros(), "ffn": mlp(), "gate_ffn": zeros(())}
    if kind == "dec":
        return {"ln1": zeros(), "attn": gqa(), "ln2": zeros(),
                "xattn": gqa(), "ln3": zeros(), "ffn": mlp()}
    if kind == "rec":
        return {"ln1": zeros(),
                "rec": rec_lib.init_rglru_block(generator, cfg, dtype,
                                                device),
                "ln2": zeros(), "ffn": mlp()}
    init = (rec_lib.init_mlstm_block if kind == "xm"
            else rec_lib.init_slstm_block)
    return {"ln": zeros(), "blk": init(generator, cfg, dtype, device)}


def _ffn(p: dict, h: Tensor, cfg: ArchConfig, use_moe: bool) -> Tensor:
    if use_moe:
        return ffn_lib.moe_forward(p, h, cfg)
    return ffn_lib.mlp_forward(p, h, cfg.act)


def _ffn_residual(p: dict, x: Tensor, cfg: ArchConfig, use_moe: bool,
                  norm: str = "ln2") -> Tensor:
    h = rms_norm(x, p[norm], cfg.norm_eps)
    return x + _ffn(p["ffn"], h, cfg, use_moe)


def _memory_layer(p: dict, x: Tensor, kind: str, cfg: ArchConfig,
                  use_moe: bool, ctx: dict) -> Tuple[Tensor, dict]:
    """A ``cross`` or ``dec`` layer over ``ctx["memory"]``, and its cache
    entry: the memory's keys and values ``xk``, ``xv`` (computed once) and,
    for ``dec``, the self-attention's ``k`` (roped) and ``v``."""
    xk, xv = attn.memory_kv(p["xattn"], ctx["memory"], cfg)
    cache = {"xk": xk, "xv": xv}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "cross":
        h = attn.attend(p["xattn"], attn.query(p["xattn"], h, cfg), xk, xv,
                        cfg, causal=False)
        x = x + torch.tanh(p["gate_attn"]) * h
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + torch.tanh(p["gate_ffn"]) * _ffn(p["ffn"], h, cfg,
                                                    use_moe), cache
    q, k, v = attn.qkv(p["attn"], h, ctx["positions"], cfg)
    x = x + attn.attend(p["attn"], q, k, v, cfg, causal=True)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + attn.attend(p["xattn"], attn.query(p["xattn"], h, cfg), xk, xv,
                        cfg, causal=False)
    cache.update(k=k, v=v)
    return _ffn_residual(p, x, cfg, use_moe, "ln3"), cache


# the mLSTM (xm) and sLSTM (xs) blocks' functions
_XLSTM = {
    "xm": dict(forward=rec_lib.mlstm_block_forward,
               prefill=rec_lib.mlstm_block_prefill,
               decode=rec_lib.mlstm_block_decode),
    "xs": dict(forward=rec_lib.slstm_block_forward,
               prefill=rec_lib.slstm_block_prefill,
               decode=rec_lib.slstm_block_decode),
}


def layer_forward(p: dict, x: Tensor, kind: str, cfg: ArchConfig,
                  use_moe: bool, ctx: dict) -> Tensor:
    check_ported(kind, cfg)
    if kind in ("cross", "dec"):
        return _memory_layer(p, x, kind, cfg, use_moe, ctx)[0]
    if kind in ("xm", "xs"):
        return x + _XLSTM[kind]["forward"](
            p["blk"], rms_norm(x, p["ln"], cfg.norm_eps), cfg,
            ctx["backend"])
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "rec":
        h = rec_lib.rglru_block_forward(p["rec"], h, cfg, ctx["backend"])
    elif _mla(cfg, kind):
        h = attn.mla_forward(p["attn"], h, ctx["positions"], cfg)
    else:
        h = attn.gqa_forward(p["attn"], h, ctx["positions"], cfg,
                             window=ctx.get("window"),
                             causal=(kind == "attn"))
    return _ffn_residual(p, x + h, cfg, use_moe)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also emits the layer's decode cache.
# ---------------------------------------------------------------------------

def layer_prefill(p: dict, x: Tensor, kind: str, cfg: ArchConfig,
                  use_moe: bool, ctx: dict) -> Tuple[Tensor, dict]:
    """Same computation as layer_forward + returns the filled cache entry
    (``xm``/``xs``: the decode step's outputs and final state, which the
    reference gets by scanning the decode step over the prompt)."""
    check_ported(kind, cfg)
    if kind in ("cross", "dec"):
        return _memory_layer(p, x, kind, cfg, use_moe, ctx)
    if kind in ("xm", "xs"):
        y, state = _XLSTM[kind]["prefill"](
            p["blk"], rms_norm(x, p["ln"], cfg.norm_eps), cfg,
            ctx["backend"])
        return x + y, state
    if kind == "enc":
        raise ValueError("an encoder layer has no decode cache")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if _mla(cfg, kind):
        y, latent = attn.mla_prefill(p["attn"], h, ctx["positions"], cfg)
        return _ffn_residual(p, x + y, cfg, use_moe), latent
    if kind == "attn":
        q, k, v = attn.qkv(p["attn"], h, ctx["positions"], cfg)
        window = ctx.get("window")
        x = _ffn_residual(p, x + attn.attend(p["attn"], q, k, v, cfg,
                                             causal=True, window=window),
                          cfg, use_moe)
        if window and k.shape[1] >= window:
            k, v = k[:, -window:], v[:, -window:]
        return x, {"k": k, "v": v}
    rp = p["rec"]
    gate, u = rec_lib.rglru_branches(rp, h)
    uc = rec_lib.temporal_conv(u, rp["conv"], ctx["backend"])
    hs = rec_lib.rglru_scan(rp, uc)
    x = _ffn_residual(p, x + (hs * gate) @ rp["w_out"], cfg, use_moe)
    return x, {"conv": rec_lib.conv_tail(u, cfg.recurrent.conv_width),
               "h": hs[:, -1].float()}


# ---------------------------------------------------------------------------
# Decode: per-kind cache init + one-token step.
# ---------------------------------------------------------------------------

def init_layer_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int,
                     dtype, ctx: dict, device=None) -> dict:
    check_ported(kind, cfg)
    hd, kh = cfg.head_dim, cfg.num_kv_heads

    def zeros(s):
        return torch.zeros((batch, s, kh, hd), dtype=dtype, device=device)

    if kind in ("cross", "dec"):
        m = ctx["memory_len"]
        cache = {"xk": zeros(m), "xv": zeros(m)}
        if kind == "dec":
            cache.update(k=zeros(max_seq), v=zeros(max_seq))
        return cache
    if kind == "attn" and _mla(cfg, kind):
        m = cfg.mla
        return {key: torch.zeros((batch, max_seq, r), dtype=dtype,
                                 device=device)
                for key, r in (("ckv", m.kv_lora_rank),
                               ("kr", m.qk_rope_dim))}
    if kind == "attn":
        window = ctx.get("window")
        s = min(max_seq, window) if window else max_seq
        return {"k": zeros(s), "v": zeros(s)}
    if kind == "rec":
        return rec_lib.rglru_init_state(batch, cfg, dtype, device)
    if kind == "xm":
        return rec_lib.mlstm_init_state(batch, cfg, dtype, device)
    if kind == "xs":
        return rec_lib.slstm_init_state(batch, cfg, dtype, device)
    raise ValueError("an encoder layer has no decode cache")


def _memory_decode(p: dict, x: Tensor, cache: dict, cfg: ArchConfig,
                   ctx: dict) -> Tensor:
    """One token's attention over the cached memory keys and values."""
    out = attn.decode_attention(attn.query(p, x, cfg), cache["xk"],
                                cache["xv"], ctx["memory_len"])
    return out.reshape(x.shape[0], 1, -1) @ p["wo"]


def layer_decode(p: dict, x: Tensor, cache: dict, kind: str,
                 cfg: ArchConfig, use_moe: bool, pos: int, ctx: dict
                 ) -> Tuple[Tensor, dict]:
    check_ported(kind, cfg)
    if kind in ("xm", "xs"):
        h, cache = _XLSTM[kind]["decode"](
            p["blk"], rms_norm(x, p["ln"], cfg.norm_eps), cache, cfg)
        return x + h, cache
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "cross":
        x = x + torch.tanh(p["gate_attn"]) * _memory_decode(
            p["xattn"], h, cache, cfg, ctx)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + torch.tanh(p["gate_ffn"]) * _ffn(p["ffn"], h, cfg,
                                                    use_moe), cache
    if kind == "dec":
        h, self_cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg)
        cache = {**cache, **self_cache}
        x = x + h
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _memory_decode(p["xattn"], h, cache, cfg, ctx)
        return _ffn_residual(p, x, cfg, use_moe, "ln3"), cache
    if kind == "attn" and _mla(cfg, kind):
        h, cache = attn.mla_decode(p["attn"], h, cache, pos, cfg)
    elif kind == "attn":
        window = ctx.get("window")
        if window and cache["k"].shape[1] <= window:
            # rolling window cache: rotate then write at the end
            h, cache = _windowed_decode(p["attn"], h, cache, pos, cfg)
        else:
            h, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg,
                                       window=window)
    elif kind == "rec":
        h, cache = rec_lib.rglru_block_decode(p["rec"], h, cache, cfg)
    else:
        raise ValueError("an encoder layer has no decode step")
    return _ffn_residual(p, x + h, cfg, use_moe), cache


def _windowed_decode(p: dict, x: Tensor, cache: dict, pos: int,
                     cfg: ArchConfig) -> Tuple[Tensor, dict]:
    """Sliding-window cache no longer than the window: roll + append.  The
    entries are right-aligned, so the last min(pos + 1, S) are real."""
    b = x.shape[0]
    q, k, v = attn.decode_qkv(p, x, pos, cfg)
    k_cache = torch.cat([cache["k"][:, 1:], k], dim=1)
    v_cache = torch.cat([cache["v"][:, 1:], v], dim=1)
    s = k_cache.shape[1]
    # keys [s - valid, s): decode_attention's window mask at kv_len = s
    out = attn.decode_attention(q, k_cache, v_cache, s,
                                window=min(pos + 1, s))
    return out.reshape(b, 1, -1) @ p["wo"], {"k": k_cache, "v": v_cache}
