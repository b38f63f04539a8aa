"""Gradient compression for the data-parallel all-reduce.

Port of ``repro.optim.compression``.  ``quantize_int8`` /
``dequantize_int8``: per-tensor-scaled int8 with stochastic rounding;
applied to microbatch gradients before accumulation, this reproduces the
numerics of an int8 gradient exchange.  Each takes an explicit
``torch.Generator`` (on the tensor's device) for the rounding noise.  The
reference's ``compressed_psum``, which moves the int8 payload across a
``shard_map`` axis, waits for multi-process training (ROADMAP Queue 1
item 7).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map

Tensor = torch.Tensor
PyTree = Any


def quantize_int8(x: Tensor, generator: torch.Generator
                  ) -> Tuple[Tensor, Tensor]:
    """Returns (int8 values, fp32 scale).  Stochastic rounding: uniform
    noise in [-0.5, 0.5) added before rounding, so the expected value of
    ``q * scale`` is ``x`` wherever it is not clipped."""
    amax = torch.max(torch.abs(x)).float()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    scaled = x.float() / scale
    noise = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=torch.float32) - 0.5
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor, dtype=torch.float32) -> Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: PyTree, generator: torch.Generator) -> PyTree:
    """Quantize->dequantize every leaf (numerics of an int8 all-reduce),
    the leaves drawing from one generator in ``tree_map``'s order; a
    ``None`` leaf (a gradient the loss does not reach) stays ``None``."""
    return tree_map(lambda g: None if g is None else dequantize_int8(
        *quantize_int8(g, generator), g.dtype), grads)
