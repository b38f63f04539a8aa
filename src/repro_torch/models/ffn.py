"""Feed-forward layers: the dense (GLU) MLP.

Port of the dense half of ``repro.models.ffn``; the capacity-based MoE
waits for ROADMAP Queue 1 item 9.3.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ACT, GLU_ACTS, dense_init

Tensor = torch.Tensor


def init_mlp(generator: torch.Generator, d: int, d_ff: int, dtype,
             act: str = "silu", device=None) -> dict:
    p = {"wi": dense_init(generator, (d, d_ff), dtype, device=device)}
    if act in GLU_ACTS:
        p["wg"] = dense_init(generator, (d, d_ff), dtype, device=device)
    p["wo"] = dense_init(generator, (d_ff, d), dtype, device=device)
    return p


def mlp_forward(p: dict, x: Tensor, act: str = "silu") -> Tensor:
    if "wg" in p:
        return (ACT[act](x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    return ACT[act](x @ p["wi"]) @ p["wo"]
