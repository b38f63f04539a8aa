"""Model-facing wrappers around the CUDA kernels.

Port of ``repro.kernels.ops``: the wrappers own layout plumbing — SAME
padding with XLA's split, and the row/column transposes that reduce FuSe-2D
to the ``fuse1d`` primitive.  The TPU path's row-window fold and
``MAX_T_CHUNK`` chunking bound VMEM tiles; the CUDA kernels index the
whole tensor, so neither is needed here.

``fuseconv_fused`` and ``depthwise_kxk`` are re-exported so
``zoo.apply_network`` has a single kernel namespace, and
``launch_counts``/``reset_launch_counts`` read and zero the four kernels'
launch counters.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

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


def fuse_conv2d_rows(x: Tensor, w_row: Tensor, *, stride: int = 1) -> Tensor:
    """Kx1 (vertical) bank via fuse1d.  x: (B,H,W,C), w_row: (K,C)."""
    b, h, wdim, c = x.shape
    k = w_row.shape[0]
    # conv along H: fold W into the problem axis -> (B*W, H, C)
    xt = x.permute(0, 2, 1, 3).reshape(b * wdim, h, c)
    out_h, lo, hi = _fused.same_pad(h, k, stride)
    x_pad = F.pad(xt, (0, 0, lo, hi))
    y = _fuse1d.fuse1d(x_pad.contiguous(), w_row.contiguous())  # (B*W, T, C)
    y = y.reshape(b, wdim, y.shape[1], c).permute(0, 2, 1, 3)
    if stride > 1:
        y = y[:, ::stride, ::stride, :]
    return y[:, :out_h]


def fuse_conv2d_cols(x: Tensor, w_col: Tensor, *, stride: int = 1) -> Tensor:
    """1xK (horizontal) bank via fuse1d.  x: (B,H,W,C), w_col: (K,C)."""
    b, h, wdim, c = x.shape
    k = w_col.shape[0]
    xt = x.reshape(b * h, wdim, c)
    out_w, lo, hi = _fused.same_pad(wdim, k, stride)
    x_pad = F.pad(xt, (0, 0, lo, hi))
    y = _fuse1d.fuse1d(x_pad.contiguous(), w_col.contiguous())
    y = y.reshape(b, h, y.shape[1], c)
    if stride > 1:
        y = y[:, ::stride, ::stride, :]
    return y[:, :, :out_w]


def fuse_conv2d_half(x: Tensor, w_row: Tensor, w_col: Tensor, *,
                     stride: int = 1) -> Tensor:
    c_r = w_row.shape[-1]
    y_r = fuse_conv2d_rows(x[..., :c_r], w_row, stride=stride)
    y_c = fuse_conv2d_cols(x[..., c_r:], w_col, stride=stride)
    return torch.cat([y_r, y_c], dim=-1)


def fuse_conv2d_full(x: Tensor, w_row: Tensor, w_col: Tensor, *,
                     stride: int = 1) -> Tensor:
    """FuSe-Full: every channel gets a row AND a column filter -> 2C out."""
    y_r = fuse_conv2d_rows(x, w_row, stride=stride)
    y_c = fuse_conv2d_cols(x, w_col, stride=stride)
    return torch.cat([y_r, y_c], dim=-1)


def pointwise(x: Tensor, w: Tensor) -> Tensor:
    """1x1 conv via the matmul kernel.  x: (..., Cin), w: (Cin, Cout)."""
    lead = x.shape[:-1]
    y = _matmul.matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                       w.contiguous())
    return y.reshape(*lead, w.shape[-1])
