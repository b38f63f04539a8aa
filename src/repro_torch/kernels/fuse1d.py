"""FuSeConv's primitive: a bank of independent 1-D convolutions.

Port of ``repro.kernels.fuse1d.fuse1d``:
``y[n, t, c] = sum_k x_pad[n, t + k, c] * w[k, c]`` with x_pad
(N, T + K - 1, C) already padded by the caller (``ops.py``) and w (K, C).
``fuse1d`` launches the CUDA kernel of ``csrc/fuse1d.cu`` for CUDA tensors
and runs ``fuse1d_plain`` (the port of ``repro.kernels.ref.fuse1d_ref``)
for CPU tensors.  ``fuse1d.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_SIGNATURES = {"repro_fuse1d_f32": (_build.PTR,) * 3 + (_build.INT,) * 4
               + (_build.PTR,)}


def fuse1d_plain(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: K shifted multiply-adds in fp32."""
    k = w.shape[0]
    t = x_pad.shape[1] - k + 1
    acc = torch.zeros((x_pad.shape[0], t, x_pad.shape[2]),
                      dtype=torch.float32, device=x_pad.device)
    for tap in range(k):
        acc = acc + x_pad[:, tap:tap + t, :].float() * w[tap].float()
    return acc.to(x_pad.dtype)


def fuse1d(x_pad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bank of independent 1-D convolutions.  x_pad: (N, T + K - 1, C),
    w: (K, C); returns (N, T, C)."""
    dev = _build.check_inputs("fuse1d", x_pad, w)
    if x_pad.ndim != 3 or w.ndim != 2 or w.shape[1] != x_pad.shape[2]:
        raise ValueError(f"fuse1d: x_pad {tuple(x_pad.shape)}, "
                         f"w {tuple(w.shape)}")
    n, tp, c = x_pad.shape
    k = w.shape[0]
    t = tp - k + 1
    if k < 1 or t < 1:
        raise ValueError(f"fuse1d: {k} taps over a padded length of {tp}")
    if dev.type == "cpu":
        return fuse1d_plain(x_pad, w)
    y = torch.empty((n, t, c), device=dev, dtype=torch.float32)
    if y.numel() == 0:
        return y
    _build.check_size("fuse1d", y)
    lib = _build.library("fuse1d", _SIGNATURES)
    _build.launch("fuse1d", lib.repro_fuse1d_f32, dev, x_pad.data_ptr(),
                  w.data_ptr(), y.data_ptr(), n, t, c, k)
    fuse1d.launches += 1
    return y


fuse1d.launches = 0
