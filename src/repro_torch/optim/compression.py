"""Gradient compression for the data-parallel all-reduce.

Port of ``repro.optim.compression``.  ``quantize_int8`` /
``dequantize_int8``: per-tensor-scaled int8 with stochastic rounding;
applied to microbatch gradients before accumulation, this reproduces the
numerics of an int8 gradient exchange.  Each takes an explicit
``torch.Generator`` (on the tensor's device) for the rounding noise.  A
DTensor (a gradient under a sharding policy) is quantized with the scale
of the whole tensor and with the noise of the whole tensor, drawn from the
generator on every rank, each rank keeping its own shard of it: the
numbers of the one-device quantization of the same values.

``compressed_psum`` moves the int8 payload across one axis of a mesh, the
counterpart of the reference's ``shard_map`` building block: each rank
quantizes its tensor, the payloads are summed in int32 and the scales
max-combined.  It keeps the reference's arithmetic: payloads quantized
with different scales are summed and multiplied by the largest, so where
the ranks' ``max|x|`` differ the result is not the sum of the inputs.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels._build import is_dtensor
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
    if is_dtensor(x):
        from torch.distributed.tensor import distribute_tensor
        noise = distribute_tensor(noise, x.device_mesh, x.placements,
                                  src_data_rank=None)
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


def compressed_psum(x: Tensor, mesh, axis_name: str,
                    generator: torch.Generator) -> Tensor:
    """The int8-payload sum of ``x`` over the ranks of ``mesh``'s axis
    ``axis_name`` (``mesh`` a ``DeviceMesh``; ``x`` each rank's own plain
    tensor, of one shape on every rank): ``quantize_int8`` with this rank's
    ``generator``, the payloads widened to int32 and summed exactly
    (``all_reduce`` SUM), the scales max-combined (``all_reduce`` MAX),
    and the sum times the largest scale, in ``x``'s dtype."""
    import torch.distributed as dist
    group = mesh.get_group(axis_name)
    q, scale = quantize_int8(x, generator)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    scale = scale.reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    return (total.float() * scale[0]).to(x.dtype)
