"""Rotary position embeddings (applied over the last head dim), in fp32.

Port of ``repro.models.rope``: the half-split rotation.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def rope_freqs(dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10_000.0
               ) -> Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    angles = positions.float()[..., None] * freqs           # (..., S, D/2)
    if x.ndim == angles.ndim + 1:                           # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)
