"""Model stack: heterogeneous layer patterns grouped into superblocks.

Port of ``repro.models.stack``.  The per-layer pattern from
``ArchConfig.layer_pattern`` is grouped into repeating *superblocks* (e.g.
RecurrentGemma's ("rec","rec","attn")); each group's parameters are
stacked on a leading axis, as in the reference, and the model walks that
axis in a Python loop where the reference scans.  Layer kinds ported:

  attn   causal self-attention (GQA) + dense FFN
  rec    RG-LRU recurrent block + dense FFN

The other kinds raise ``NotImplementedError`` naming the ROADMAP item
that ports them.  ``ctx`` carries ``positions``, ``window`` and the
``backend`` that picks the temporal conv's path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.common import rms_norm
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor

# kinds (and features) the port does not serve yet -> the ROADMAP item
NOT_PORTED = {
    "xm": "ROADMAP Queue 1 item 9.2 (xLSTM blocks)",
    "xs": "ROADMAP Queue 1 item 9.2 (xLSTM blocks)",
    "moe": "ROADMAP Queue 1 item 9.3 (MoE and MLA)",
    "mla": "ROADMAP Queue 1 item 9.3 (MoE and MLA)",
    "cross": "ROADMAP Queue 1 item 9.4 (cross, decoder and encoder layers)",
    "dec": "ROADMAP Queue 1 item 9.4 (cross, decoder and encoder layers)",
    "enc": "ROADMAP Queue 1 item 9.4 (cross, decoder and encoder layers)",
}


def check_ported(kind: str, cfg: ArchConfig, use_moe: bool) -> None:
    """Raise ``NotImplementedError`` for a layer the port does not run."""
    for key, missing in ((kind, kind not in ("attn", "rec")),
                         ("moe", use_moe),
                         ("mla", kind == "attn" and cfg.attn_kind == "mla")):
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {key!r} is not ported yet: "
                f"{NOT_PORTED.get(key, 'no ROADMAP item')}")


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
    check_ported(kind, cfg, use_moe)
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    block = (attn.init_gqa(generator, cfg, dtype, device) if kind == "attn"
             else rec_lib.init_rglru_block(generator, cfg, dtype, device))
    return {"ln1": zeros(), kind: block, "ln2": zeros(),
            "ffn": ffn_lib.init_mlp(generator, d, cfg.d_ff, dtype, cfg.act,
                                    device)}


def _ffn_residual(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_lib.mlp_forward(p["ffn"], h, cfg.act)


def layer_forward(p: dict, x: Tensor, kind: str, cfg: ArchConfig,
                  use_moe: bool, ctx: dict) -> Tensor:
    check_ported(kind, cfg, use_moe)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        h = attn.gqa_forward(p["attn"], h, ctx["positions"], cfg,
                             window=ctx.get("window"))
    else:
        h = rec_lib.rglru_block_forward(p["rec"], h, cfg, ctx["backend"])
    return _ffn_residual(p, x + h, cfg)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also emits the layer's decode cache.
# ---------------------------------------------------------------------------

def layer_prefill(p: dict, x: Tensor, kind: str, cfg: ArchConfig,
                  use_moe: bool, ctx: dict) -> Tuple[Tensor, dict]:
    """Same computation as layer_forward + returns the filled cache entry."""
    check_ported(kind, cfg, use_moe)
    b, s, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        q, k, v = attn.qkv(p["attn"], h, ctx["positions"], cfg)
        out = attn.blockwise_attention(q, k, v, causal=True,
                                       window=ctx.get("window"),
                                       q_chunk=cfg.attn_q_chunk,
                                       kv_chunk=cfg.attn_kv_chunk)
        x = _ffn_residual(p, x + out.reshape(b, s, -1) @ p["attn"]["wo"],
                          cfg)
        window = ctx.get("window")
        if window and s >= window:
            k, v = k[:, -window:], v[:, -window:]
        return x, {"k": k, "v": v}
    rp = p["rec"]
    gate, u = rec_lib.rglru_branches(rp, h)
    cw = cfg.recurrent.conv_width
    conv_tail = u[:, -(cw - 1):, :]
    if s < cw - 1:
        conv_tail = F.pad(u, (0, 0, cw - 1 - s, 0))
    uc = rec_lib.temporal_conv(u, rp["conv"], ctx["backend"])
    hs = rec_lib.rglru_scan(rp, uc)
    x = _ffn_residual(p, x + (hs * gate) @ rp["w_out"], cfg)
    return x, {"conv": conv_tail, "h": hs[:, -1].float()}


# ---------------------------------------------------------------------------
# Decode: per-kind cache init + one-token step.
# ---------------------------------------------------------------------------

def init_layer_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int,
                     dtype, ctx: dict, device=None) -> dict:
    check_ported(kind, cfg, False)
    if kind == "attn":
        hd, kh = cfg.head_dim, cfg.num_kv_heads
        window = ctx.get("window")
        s = min(max_seq, window) if window else max_seq
        return {"k": torch.zeros((batch, s, kh, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, s, kh, hd), dtype=dtype,
                                 device=device)}
    return rec_lib.rglru_init_state(batch, cfg, dtype, device)


def layer_decode(p: dict, x: Tensor, cache: dict, kind: str,
                 cfg: ArchConfig, use_moe: bool, pos: int, ctx: dict
                 ) -> Tuple[Tensor, dict]:
    check_ported(kind, cfg, use_moe)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        window = ctx.get("window")
        if window and cache["k"].shape[1] <= window:
            # rolling window cache: rotate then write at the end
            h, cache = _windowed_decode(p["attn"], h, cache, pos, cfg)
        else:
            h, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg,
                                       window=window)
    else:
        h, cache = rec_lib.rglru_block_decode(p["rec"], h, cache, cfg)
    return _ffn_residual(p, x + h, cfg), cache


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
