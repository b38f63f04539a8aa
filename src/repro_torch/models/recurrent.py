"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin).

Port of the RG-LRU half of ``repro.models.recurrent``; the xLSTM blocks
(mLSTM/sLSTM) wait for ROADMAP Queue 1 item 9.2.

The block's causal temporal depthwise convolution is a bank of independent
1-D convolutions, the FuSeConv primitive.  It goes through the model's
backend: ``torch`` runs the plain op ``core.fuseconv.fuse_conv1d_temporal``,
``cuda`` the hand ``fuse1d`` kernel through
``kernels.ops.fuse_conv1d_temporal`` (one launch per block).  A decode
step's K-tap window stays the plain ``fuse_conv1d_temporal_step``.

The linear recurrence h_t = a_t h_{t-1} + b_t runs as a log-depth doubling
scan (forward only: the reference's custom VJP belongs to training).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import fuseconv as fc
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import Backend
from repro_torch.models.common import dense_init, gelu
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


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1, h_0 = 0, by doubling: after
    the step of stride d, (a_t, b_t) compose the 2d steps ending at t."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p: dict, x: Tensor) -> Tensor:
    """Full-sequence RG-LRU over (B, S, W)."""
    a, b = _rglru_coeffs(p, x)
    return linear_scan(a, b).to(x.dtype)


def temporal_conv(x: Tensor, w: Tensor, backend: Backend) -> Tensor:
    """The block's causal temporal FuSeConv on the backend's path."""
    if backend.use_kernels:
        return kops.fuse_conv1d_temporal(x, w, causal=True)
    return fc.fuse_conv1d_temporal(x, w, causal=True)


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
