"""Shared NN primitives for the LM stack (PyTorch, explicit param trees).

Port of ``repro.models.common``.  Two numerics follow the JAX package on
purpose: ``jax.nn.gelu`` defaults to the tanh approximation, so
``ACT["gelu"]`` is ``F.gelu(x, approximate="tanh")``; and ``rms_norm``
computes in fp32, scales by ``1 + scale`` and casts back.  ``pad`` is
``F.pad`` that also takes a DTensor (an LM under a sharding policy).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._build import is_dtensor

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return DTYPES[name]


def normal(generator: torch.Generator, shape: Sequence[int]) -> Tensor:
    """fp32 standard normals drawn from ``generator`` on its own device."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None, device=None) -> Tensor:
    fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (normal(generator, shape) * s).to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> Tensor:
    # 1/sqrt(d) keeps tied-head logits O(1) at init
    s = 1.0 / np.sqrt(d)
    return (normal(generator, (vocab, d)) * s).to(device=device, dtype=dtype)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACT = {
    "silu": F.silu,
    "gelu": gelu,
    "relu": torch.relu,
    "gelu_plain": gelu,                 # plain 2-matrix MLP (no GLU)
    "relu_sq": lambda x: torch.relu(x).square(),   # nemotron-style
}

GLU_ACTS = ("silu", "gelu")        # acts realized as gated (3-matrix) MLPs


def softcap(x: Tensor, cap: float) -> Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def pad(x: Tensor, pads: Sequence[int], value: float = 0.0) -> Tensor:
    """``F.pad(x, pads, value=value)``.  A DTensor is padded on each rank's
    shard under ``local_map``, after the padded dims (and a pending sum)
    are made whole; the other shards stay.  (DTensor's own rule for
    ``constant_pad_nd`` returns one placement for a 2-D mesh in PyTorch
    2.11.)"""
    if not is_dtensor(x):
        return F.pad(x, pads, value=value)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pads) if n}
    layout = [Replicate() if p.is_partial() or (
        isinstance(p, Shard) and p.dim % x.ndim in padded) else p
        for p in x.placements]
    return local_map(lambda t: F.pad(t, pads, value=value),
                     out_placements=layout, in_placements=(layout,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)
