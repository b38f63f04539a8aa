"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin) and xLSTM (mLSTM/sLSTM).

Port of ``repro.models.recurrent``.  Each block opens with a causal
temporal depthwise convolution, a bank of independent 1-D convolutions:
the FuSeConv primitive.  It goes through the model's backend: ``torch``
runs the plain op ``core.fuseconv.fuse_conv1d_temporal``, ``cuda`` the hand
``fuse1d`` kernel through ``kernels.ops.fuse_conv1d_temporal`` (one launch
per block per full-sequence call).  A decode step's K-tap window stays the
plain ``fuse_conv1d_temporal_step``.

The RG-LRU's linear recurrence h_t = a_t h_{t-1} + b_t runs as a log-depth
doubling scan, and trains through the reference's custom VJP: a
``torch.autograd.Function`` that saves only (a, h) and runs the reverse
recurrence as the same doubling scan.  The xLSTM cells are nonlinear and
run step by step over time, as the reference's ``lax.scan`` does, with
their state in fp32 and the stabilizer ``m`` starting at -inf.  Their prefill (``*_block_prefill``)
hoists the projections and the conv out of the time loop (the conv of
step t reads only inputs) and keeps the decode step's casts, so it returns
what the reference's ``layer_prefill`` gets by running the decode step
over the prompt: every position's output and the final state.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import fuseconv as fc
from repro_torch.kernels import ops as kops
from repro_torch.kernels._build import is_dtensor
from repro_torch.kernels.backend import Backend
from repro_torch.models.common import dense_init, gelu, pad, rms_norm
from repro_torch.models.config import ArchConfig, RecurrentConfig

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Block-diagonal linear (Griffin gate projections).
# ---------------------------------------------------------------------------

def init_blockdiag(generator: torch.Generator, w: int, blocks: int, dtype,
                   device=None) -> Tensor:
    bw = w // blocks
    return dense_init(generator, (blocks, bw, bw), dtype, device=device)


def blockdiag_apply(wt: Tensor, x: Tensor) -> Tensor:
    nb, bw, _ = wt.shape
    lead = x.shape[:-1]
    xb = x.reshape(*lead, nb, bw)
    y = torch.einsum("...nb,nbc->...nc", xb, wt)
    return y.reshape(*lead, nb * bw)


# ---------------------------------------------------------------------------
# RG-LRU.
# ---------------------------------------------------------------------------

def init_rglru_block(generator: torch.Generator, cfg: ArchConfig, dtype,
                     device=None) -> dict:
    rc: RecurrentConfig = cfg.recurrent
    d = cfg.d_model
    w = int(d * rc.width_factor)
    nb = rc.heads or 16
    kw = dict(device=device)
    return {
        "w_in": dense_init(generator, (d, w), dtype, **kw),
        "w_gate": dense_init(generator, (d, w), dtype, **kw),
        "conv": dense_init(generator, (rc.conv_width, w), dtype, **kw),
        "wa": init_blockdiag(generator, w, nb, dtype, **kw),
        "wx": init_blockdiag(generator, w, nb, dtype, **kw),
        # softplus-parameter of a
        "lam": torch.linspace(0.5, 4.0, w).to(device=device, dtype=dtype),
        "w_out": dense_init(generator, (w, d), dtype, **kw),
    }


def _rglru_coeffs(p: dict, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (..., W) post-conv branch.  Returns per-step (a, b) of
    h_t = a_t * h_{t-1} + b_t, computed in fp32."""
    x32 = x.float()
    r = torch.sigmoid(blockdiag_apply(p["wa"].float(), x32))
    i = torch.sigmoid(blockdiag_apply(p["wx"].float(), x32))
    log_a = -8.0 * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    gated = x32 * i
    b = gated * torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                       min=1e-12))
    return a, b


def _doubling_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1, h_0 = 0, by doubling: after
    the step of stride d, (a_t, b_t) compose the 2d steps ending at t."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


class _LinearScan(torch.autograd.Function):
    """The reference's custom VJP (``recurrent.py:86-123``): the forward
    saves only (a, h); the backward runs the reverse recurrence
    g_t = dh_t + a_{t+1} g_{t+1} (db = g, da_t = g_t h_{t-1}) as the same
    doubling scan over the time-reversed (a_{t+1}, dh).  Autograd through
    the doubling scan would keep log2(S) levels of (B, S, W) pairs."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        h = _doubling_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh: Tensor):
        a, h = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        g = _doubling_scan(a_next.flip(1), dh.flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return g * h_prev, g


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1, h_0 = 0: a log-depth
    doubling scan, differentiable with the reference's memory-light rule
    (``_LinearScan``).  DTensors a, b (B, S, W) run it on each rank's
    shard under ``local_map``: their batch (dim 0) and channel (dim 2)
    shards stay, time is made whole (the recurrence is elementwise in B
    and W), and the backward runs on the same local shards."""
    if is_dtensor(a):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        layout = [p if p in (Shard(0), Shard(2)) else Replicate()
                  for p in a.placements]
        return local_map(_LinearScan.apply, out_placements=layout,
                         in_placements=(layout, layout),
                         device_mesh=a.device_mesh,
                         redistribute_inputs=True)(a, b)
    return _LinearScan.apply(a, b)


def rglru_scan(p: dict, x: Tensor) -> Tensor:
    """Full-sequence RG-LRU over (B, S, W)."""
    a, b = _rglru_coeffs(p, x)
    return linear_scan(a, b).to(x.dtype)


def temporal_conv(x: Tensor, w: Tensor, backend: Backend, *,
                  causal: bool = True) -> Tensor:
    """The temporal FuSeConv (causal, or centred for a stem) on the
    backend's path; a DTensor x on each rank's shard."""
    if backend.use_kernels:
        return kops.fuse_conv1d_temporal(x, w, causal=causal)
    if is_dtensor(x):
        return kops.on_local_channels(fc.fuse_conv1d_temporal, x, w,
                                      causal=causal)
    return fc.fuse_conv1d_temporal(x, w, causal=causal)


def conv_tail(u: Tensor, conv_width: int) -> Tensor:
    """The decode state a causal conv leaves after the sequence u
    (B, S, C): its last K-1 inputs, zero-padded on the left when S < K-1."""
    return pad(u, (0, 0, conv_width - 1, 0))[:, u.shape[1]:]


def rglru_branches(p: dict, x: Tensor) -> Tuple[Tensor, Tensor]:
    """(gate, u): the gelu gate branch and the recurrent branch's input."""
    return gelu(x @ p["w_gate"]), x @ p["w_in"]


def rglru_block_forward(p: dict, x: Tensor, cfg: ArchConfig,
                        backend: Backend) -> Tensor:
    gate, h = rglru_branches(p, x)
    h = temporal_conv(h, p["conv"], backend)
    h = rglru_scan(p, h)
    return (h * gate) @ p["w_out"]


def rglru_block_decode(p: dict, x: Tensor, state: dict, cfg: ArchConfig
                       ) -> Tuple[Tensor, dict]:
    """x: (B,1,D); state: {conv: (B,K-1,W), h: (B,W)}."""
    gate, u = rglru_branches(p, x)
    gate, u = gate[:, 0], u[:, 0]                            # (B, W)
    conv_state, u = fc.fuse_conv1d_temporal_step(state["conv"], u, p["conv"])
    a, b = _rglru_coeffs(p, u)
    h = a * state["h"].float() + b
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    return y[:, None, :], {"conv": conv_state, "h": h}


def rglru_init_state(batch: int, cfg: ArchConfig, dtype, device=None
                     ) -> dict:
    rc = cfg.recurrent
    w = int(cfg.d_model * rc.width_factor)
    return {"conv": torch.zeros((batch, rc.conv_width - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating).
# ---------------------------------------------------------------------------

def _xlstm_heads(cfg: ArchConfig) -> int:
    return cfg.recurrent.heads or cfg.num_heads


def init_mlstm_block(generator: torch.Generator, cfg: ArchConfig, dtype,
                     device=None) -> dict:
    rc: RecurrentConfig = cfg.recurrent
    d = cfg.d_model
    di = 2 * d                      # official up-projection factor 2
    h = _xlstm_heads(cfg)
    kw = dict(device=device)
    return {
        "w_up": dense_init(generator, (d, 2 * di), dtype, **kw),  # [x_m, z]
        "conv": dense_init(generator, (rc.conv_width, di), dtype, **kw),
        "wq": dense_init(generator, (di, di), dtype, **kw),
        "wk": dense_init(generator, (di, di), dtype, **kw),
        "wv": dense_init(generator, (di, di), dtype, **kw),
        "w_if": dense_init(generator, (di, 2 * h), dtype, **kw),  # i,f logits
        "norm": torch.zeros((di,), dtype=dtype, **kw),
        "w_down": dense_init(generator, (di, d), dtype, **kw),
    }


def _mlstm_step(state: Tuple[Tensor, Tensor, Tensor], qt: Tensor,
                kt: Tensor, vt: Tensor, it: Tensor, ft: Tensor
                ) -> Tuple[Tuple[Tensor, Tensor, Tensor], Tensor]:
    """One stabilized mLSTM step in fp32.  state (c (B,H,Dh,Dh), n (B,H,Dh),
    m (B,H)); qt, kt (scaled by 1/sqrt(Dh)) and vt (B,H,Dh); it and the
    log-sigmoid forget gate ft (B,H).  Returns the new state and the
    output (B,H,Dh)."""
    c, n, m = state
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c = f_p[..., None, None] * c + \
        i_p[..., None, None] * (kt[..., :, None] * vt[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * kt
    num = torch.einsum("bhd,bhdv->bhv", qt, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qt, n).abs(),
                        torch.exp(-m_new))
    return (c, n, m_new), num / den[..., None]


def _mlstm_cell_inputs(q: Tensor, k: Tensor, v: Tensor, i_log: Tensor,
                       f_log: Tensor):
    """The cell's fp32 inputs: q and k over sqrt(Dh), the forget gate
    through log-sigmoid."""
    scale = math.sqrt(q.shape[-1])
    return (q.float() / scale, k.float() / scale, v.float(), i_log.float(),
            F.logsigmoid(f_log.float()))


def mlstm_cell_scan(q: Tensor, k: Tensor, v: Tensor, i_log: Tensor,
                    f_log: Tensor) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    """Stabilized recurrent mLSTM from the zero state.  q, k, v (B,S,H,Dh);
    gates (B,S,H).  Returns the outputs (B,S,H,Dh) in fp32 and the final
    state (c, n, m)."""
    b, s, h, dh = q.shape
    q, k, v, i_log, f_log = _mlstm_cell_inputs(q, k, v, i_log, f_log)
    dev = q.device
    state = (torch.zeros((b, h, dh, dh), device=dev),
             torch.zeros((b, h, dh), device=dev),
             torch.full((b, h), -math.inf, device=dev))
    ys = []
    for t in range(s):
        state, y = _mlstm_step(state, q[:, t], k[:, t], v[:, t], i_log[:, t],
                               f_log[:, t])
        ys.append(y)
    return torch.stack(ys, 1), state


def _mlstm_sequence(p: dict, x: Tensor, cfg: ArchConfig, backend: Backend):
    """The mLSTM block over a whole sequence up to its cell: the
    up-projection, the conv (one ``fuse1d`` launch on ``cuda``) and the
    cell scan.  Returns (y (B,S,di) fp32, xm, xc, z, final cell state)."""
    b, s, _ = x.shape
    h = _xlstm_heads(cfg)
    xm, z = (x @ p["w_up"]).chunk(2, dim=-1)
    xc = F.silu(temporal_conv(xm, p["conv"], backend))
    q = (xc @ p["wq"]).reshape(b, s, h, -1)
    k = (xc @ p["wk"]).reshape(b, s, h, -1)
    v = (xm @ p["wv"]).reshape(b, s, h, -1)
    gates = (xc @ p["w_if"]).reshape(b, s, 2, h)
    y, state = mlstm_cell_scan(q, k, v, gates[:, :, 0], gates[:, :, 1])
    return y.reshape(b, s, -1), xm, xc, z, state


def mlstm_block_forward(p: dict, x: Tensor, cfg: ArchConfig,
                        backend: Backend) -> Tensor:
    """As the reference's forward, the cell output stays fp32 through the
    norm and the down-projection, and is cast to x's dtype at the end."""
    y, _, xc, z, _ = _mlstm_sequence(p, x, cfg, backend)
    y = rms_norm(y, p["norm"], cfg.norm_eps) + xc
    y = y * F.silu(z)
    return (y @ p["w_down"].to(y.dtype)).to(x.dtype)


def mlstm_block_prefill(p: dict, x: Tensor, cfg: ArchConfig,
                        backend: Backend) -> Tuple[Tensor, dict]:
    """The decode step run over the prompt from the zero state, hoisted:
    outputs (B,S,D) with the decode step's cast of the cell output to x's
    dtype before the norm, and the final state."""
    y, xm, xc, z, (c, n, m) = _mlstm_sequence(p, x, cfg, backend)
    y = rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps) + xc
    y = y * F.silu(z)
    state = {"conv": conv_tail(xm, cfg.recurrent.conv_width), "c": c,
             "n": n, "m": m}
    return y @ p["w_down"], state


def mlstm_block_decode(p: dict, x: Tensor, state: dict, cfg: ArchConfig
                       ) -> Tuple[Tensor, dict]:
    """x: (B,1,D); state: {conv (B,K-1,di), c, n, m}."""
    b = x.shape[0]
    h = _xlstm_heads(cfg)
    xm, z = (x @ p["w_up"])[:, 0].chunk(2, dim=-1)
    conv_state, xc = fc.fuse_conv1d_temporal_step(state["conv"], xm,
                                                  p["conv"])
    xc = F.silu(xc)
    q = (xc @ p["wq"]).reshape(b, h, -1)
    k = (xc @ p["wk"]).reshape(b, h, -1)
    v = (xm @ p["wv"]).reshape(b, h, -1)
    gates = (xc @ p["w_if"]).reshape(b, 2, h)
    (c, n, m), y = _mlstm_step(
        (state["c"], state["n"], state["m"]),
        *_mlstm_cell_inputs(q, k, v, gates[:, 0], gates[:, 1]))
    y = rms_norm(y.reshape(b, -1).to(x.dtype), p["norm"], cfg.norm_eps) + xc
    y = y * F.silu(z)
    return (y @ p["w_down"])[:, None, :], \
        {"conv": conv_state, "c": c, "n": n, "m": m}


def mlstm_init_state(batch: int, cfg: ArchConfig, dtype, device=None
                     ) -> dict:
    di = 2 * cfg.d_model
    h = _xlstm_heads(cfg)
    dh = di // h
    kw = dict(device=device)
    return {"conv": torch.zeros((batch, cfg.recurrent.conv_width - 1, di),
                                dtype=dtype, **kw),
            "c": torch.zeros((batch, h, dh, dh), **kw),
            "n": torch.zeros((batch, h, dh), **kw),
            "m": torch.full((batch, h), -math.inf, **kw)}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, recurrent h-dependence).
# ---------------------------------------------------------------------------

def init_slstm_block(generator: torch.Generator, cfg: ArchConfig, dtype,
                     device=None) -> dict:
    rc: RecurrentConfig = cfg.recurrent
    d = cfg.d_model
    h = _xlstm_heads(cfg)
    dff = int(d * 4 / 3)
    kw = dict(device=device)
    return {
        "conv": dense_init(generator, (rc.conv_width, d), dtype, **kw),
        "w_gates": dense_init(generator, (d, 4 * d), dtype, **kw),  # i,f,z,o
        "r_gates": init_blockdiag(generator, 4 * d, 4 * h, dtype, **kw),
        "norm": torch.zeros((d,), dtype=dtype, **kw),
        "ffn_wi": dense_init(generator, (d, dff), dtype, **kw),
        "ffn_wg": dense_init(generator, (d, dff), dtype, **kw),
        "ffn_wo": dense_init(generator, (dff, d), dtype, **kw),
    }


def _slstm_step(p: dict, carry: Tuple[Tensor, ...], xt: Tensor
                ) -> Tuple[Tensor, ...]:
    """One sLSTM step in fp32: carry (c, n, m, h) (B,D) each, xt the
    gates' input projection (B,4D).  Returns the new carry."""
    c, n, m, h_prev = carry
    pre = xt + blockdiag_apply(p["r_gates"].float(), h_prev.repeat(1, 4))
    i_t, f_t, z_t, o_t = pre.chunk(4, dim=-1)
    f_log = F.logsigmoid(f_t)
    m_new = torch.maximum(f_log + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_log + m - m_new)
    c = f_p * c + i_p * torch.tanh(z_t)
    n = f_p * n + i_p
    h = torch.sigmoid(o_t) * c / torch.clamp(n, min=1e-6)
    return c, n, m_new, h


def _slstm_out(p: dict, h: Tensor, cfg: ArchConfig, dtype) -> Tensor:
    """The cell output cast to the model dtype, normed, through the gated
    FFN."""
    y = rms_norm(h.to(dtype), p["norm"], cfg.norm_eps)
    return (gelu(y @ p["ffn_wg"]) * (y @ p["ffn_wi"])) @ p["ffn_wo"]


def slstm_block_prefill(p: dict, x: Tensor, cfg: ArchConfig,
                        backend: Backend) -> Tuple[Tensor, dict]:
    """The block over a sequence from the zero state: the conv (one
    ``fuse1d`` launch on ``cuda``) and the gates' projection hoisted, the
    cell step by step.  Returns the outputs (B,S,D) and the final state.
    The reference's forward and decode step cast alike, so this is also
    the forward."""
    b, s, d = x.shape
    xc = F.silu(temporal_conv(x, p["conv"], backend))
    pre = (xc @ p["w_gates"]).float()                       # (B,S,4D)
    z0 = torch.zeros((b, d), device=x.device)
    carry = (z0, z0, torch.full((b, d), -math.inf, device=x.device), z0)
    hs = []
    for t in range(s):
        carry = _slstm_step(p, carry, pre[:, t])
        hs.append(carry[3])
    c, n, m, h = carry
    state = {"conv": conv_tail(x, cfg.recurrent.conv_width), "c": c,
             "n": n, "m": m, "h": h}
    return _slstm_out(p, torch.stack(hs, 1), cfg, x.dtype), state


def slstm_block_forward(p: dict, x: Tensor, cfg: ArchConfig,
                        backend: Backend) -> Tensor:
    return slstm_block_prefill(p, x, cfg, backend)[0]


def slstm_block_decode(p: dict, x: Tensor, state: dict, cfg: ArchConfig
                       ) -> Tuple[Tensor, dict]:
    """x: (B,1,D); state: {conv (B,K-1,D), c, n, m, h}."""
    conv_state, xc = fc.fuse_conv1d_temporal_step(state["conv"], x[:, 0],
                                                  p["conv"])
    pre = (F.silu(xc) @ p["w_gates"]).float()
    c, n, m, h = _slstm_step(
        p, (state["c"], state["n"], state["m"], state["h"]), pre)
    y = _slstm_out(p, h, cfg, x.dtype)
    return y[:, None, :], {"conv": conv_state, "c": c, "n": n, "m": m,
                           "h": h}


def slstm_init_state(batch: int, cfg: ArchConfig, dtype, device=None
                     ) -> dict:
    d = cfg.d_model
    kw = dict(device=device)
    return {"conv": torch.zeros((batch, cfg.recurrent.conv_width - 1, d),
                                dtype=dtype, **kw),
            "c": torch.zeros((batch, d), **kw),
            "n": torch.zeros((batch, d), **kw),
            "m": torch.full((batch, d), -math.inf, **kw),
            "h": torch.zeros((batch, d), **kw)}
