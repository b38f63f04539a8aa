"""Model-facing wrappers around the CUDA kernels.

Port of ``repro.kernels.ops``.  On the TPU these wrappers own layout
plumbing: SAME padding with XLA's split, the row/column transposes that
reduce FuSe-2D to the ``fuse1d`` primitive, the row-window fold and
``MAX_T_CHUNK`` chunking that bound VMEM tiles, and the concat.  Here a
FuSe spatial stage, or one of its banks alone, is one launch of
``fuse1d.fuse_stage``, which indexes x in place and writes its output once
(the TPU path's composition is its plain version); the LM stack's temporal
form is one launch of ``fuse1d.fuse_temporal``, with the causal halo in
the kernel and no chunking.  On DTensors (an LM under a sharding policy)
the temporal form runs the kernel on each rank's local shard through
``local_map``: a depthwise bank needs no collective over the batch or the
channels, only the time axis has to be whole.

``fuseconv_fused`` and ``depthwise_kxk`` are re-exported so
``zoo.apply_network`` has a single kernel namespace, and
``launch_counts``/``reset_launch_counts`` read and zero the four kernels'
launch counters (and ``fuse1d``'s count by shape).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fuse1d as _fuse1d
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import matmul as _matmul

Tensor = torch.Tensor

fuseconv_fused = _fused.fuseconv_fused
depthwise_kxk = _fused.depthwise_kxk

KERNELS = {"fuseconv_fused": _fused.fuseconv_fused,
           "fuse1d": _fuse1d.fuse1d,
           "matmul": _matmul.matmul,
           "depthwise_kxk": _fused.depthwise_kxk}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _fuse1d.fuse1d.by_shape.clear()


def fuse_conv1d_temporal(x: Tensor, w: Tensor, *, causal: bool = True
                         ) -> Tensor:
    """Depthwise temporal conv via the fuse1d kernel.  x: (B,T,C), w: (K,C);
    float32 or bfloat16.  With x a DTensor, one launch per rank on its
    local shard (``on_local_channels``)."""
    if _build.is_dtensor(x):
        return on_local_channels(_fuse1d.fuse_temporal, x, w, causal=causal)
    return _fuse1d.fuse_temporal(x.contiguous(), w.contiguous(),
                                 causal=causal)


def on_local_channels(conv, x, w, *, causal: bool):
    """``conv(x, w, causal=causal)``, a depthwise temporal conv, for a
    DTensor x (B, T, C) on each rank's shard: x keeps its batch (dim 0)
    and channel (dim 2) shards and is made whole over time (a time shard,
    ``tp_seq``'s residual stream, or a pending sum is redistributed), w
    (K, C) takes x's channel shards, and ``conv`` runs on the local
    (B/data, T, C/model) against (K, C/model) under ``local_map``.  The
    output keeps x's placements.  In a backward pass w's gradient is a
    partial sum over the axes that shard x's batch (each rank saw only its
    rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl = [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in x.placements]
    w_pl = [Shard(1) if p == Shard(2) else Replicate() for p in x_pl]
    dw_pl = [Partial() if p == Shard(0) else q for p, q in zip(x_pl, w_pl)]

    def local(xl: Tensor, wl: Tensor) -> Tensor:
        if xl.shape[2] != wl.shape[1]:
            raise ValueError(f"temporal conv: local x {tuple(xl.shape)} "
                             f"against local w {tuple(wl.shape)}")
        return conv(xl.contiguous(), wl.contiguous(), causal=causal)

    # one output: its placements as a list (a tuple would mean one entry
    # per output)
    return local_map(local, out_placements=x_pl, in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_pl, dw_pl),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def fuse_conv2d_rows(x: Tensor, w_row: Tensor, *, stride: int = 1) -> Tensor:
    """Kx1 (vertical) bank.  x: (B,H,W,C), w_row: (K,C)."""
    return _fuse1d.fuse_stage(x.contiguous(), w_row.contiguous(),
                              w_row.new_empty((w_row.shape[0], 0)),
                              stride=stride)


def fuse_conv2d_cols(x: Tensor, w_col: Tensor, *, stride: int = 1) -> Tensor:
    """1xK (horizontal) bank.  x: (B,H,W,C), w_col: (K,C)."""
    return _fuse1d.fuse_stage(x.contiguous(),
                              w_col.new_empty((w_col.shape[0], 0)),
                              w_col.contiguous(), stride=stride)


def fuse_conv2d_half(x: Tensor, w_row: Tensor, w_col: Tensor, *,
                     stride: int = 1) -> Tensor:
    """FuSe-Half: row bank on channels [:C_r], column bank on [C_r:]."""
    return _fuse1d.fuse_stage(x.contiguous(), w_row.contiguous(),
                              w_col.contiguous(), variant="fuse_half",
                              stride=stride)


def fuse_conv2d_full(x: Tensor, w_row: Tensor, w_col: Tensor, *,
                     stride: int = 1) -> Tensor:
    """FuSe-Full: every channel gets a row AND a column filter -> 2C out."""
    return _fuse1d.fuse_stage(x.contiguous(), w_row.contiguous(),
                              w_col.contiguous(), variant="fuse_full",
                              stride=stride)


def pointwise(x: Tensor, w: Tensor) -> Tensor:
    """1x1 conv via the matmul kernel.  x: (..., Cin), w: (Cin, Cout)."""
    lead = x.shape[:-1]
    y = _matmul.matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                       w.contiguous())
    return y.reshape(*lead, w.shape[-1])
